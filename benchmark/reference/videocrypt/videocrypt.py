"""Free-access Videocrypt I, the plain way: upstream hacktv's line process
`vc_render_line` (src/videocrypt.c) for `--videocrypt free`, written from
its description, one line at a time in stream order.

Per frame, on its line 1:
  - the active 32-byte message is reloaded every 8th frame from the
    block's messages (the free-access block's are all zero), its last
    byte the two's complement of the sum of the other 31;
  - the 40-byte VBI packet is the first or the second half of the
    message (4 frames each), after a header byte (the sequence byte of
    the frame counter's bits 4-6, nibble-swapped for the second half)
    and a second byte (the frame counter, or the block's mode), each
    10-byte half closed by its byte sum; every byte is Hamming-coded as
    two bytes and six 8-byte groups (at 0, 6, 12, 20, 26 and 32, in that
    order, in place) are bit-transposed with their first and last byte
    reversed first;
  - the PRBS's two LFSRs (31 and 29 bits) are loaded from the initial
    word: the control word xor the 8-bit frame counter repeated eight
    times, alternately inverted; the frame counter then steps.
  - On lines 12-15 and 325-328 the packet's 5-byte rows go out as 40
    flat-topped symbols (`vbidata_render`), least significant bit first.
  - On lines 23-309 and 335-621 the cut byte is the top byte of the
    16-bit output register `c`; then both LFSRs shift 16 times, and each
    time a multiplexer picks a bit of LFSR 1 by an address from the top
    five bits of LFSR 2 and shifts it into `c`.  The line then carries
    the next line's picture rotated about the cut point: on the 14-MHz
    timing grid, the 710 samples from the left edge hold the next line
    from `710 - cut` on and then from the left edge again, where
    cut = 105 + 2 (255 - byte), the overlap of 15 samples included.
    Line 23 is left alone (upstream's hack to let WSS through), though
    its PRBS still runs.

`c` is the only state carried from frame to frame (the LFSRs are loaded
afresh on each line 1), and in free access the control word never
changes, so a frame follows from its number alone and the frame before
it: `prbs_frame` takes the `c` that ends the previous frame.

Departures from upstream: the line buffers are float32 rows (upstream's
are int16; every operation here is a move, or an add of integers to the
rows), and the symbols' values are kept as int64 and added once per line,
as upstream's int16 adds on a blanking line are exact.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.codec.ops.shapes import rc_window

VC_SAMPLE_RATE = 14_000_000
VC_WIDTH = VC_SAMPLE_RATE // 25 // 625        # 896 samples a line
VC_LEFT = 120
VC_RIGHT = VC_LEFT + 710
VC_OVERLAP = 15
# lines carrying the VBI packet: 4 a field, 5 bytes (40 symbols) a line
VBI_FIELD_STARTS = (12, 325)
VBI_LINES_PER_FIELD = 4
VBI_BYTES_PER_LINE = 5
# lines whose PRBS runs: 287 a field
FIELD_STARTS = (23, 335)
LINES_PER_FIELD = 287
WSS_LINE = 23

FREE_ACCESS_CW = (1 << 60) - 1
FREE_ACCESS_MODE = 0x05
# the free-access block: 7 messages of 32 zero bytes
FREE_ACCESS_MESSAGES = [[0] * 32 for _ in range(7)]

LFSR1_BITS, LFSR1_TAPS = 31, 0x7BB88888
LFSR2_BITS, LFSR2_TAPS = 29, 0x17A2C100

SEQUENCE = (0x87, 0x96, 0xA5, 0xB4, 0xC3, 0xD2, 0xE1, 0x87)
HAMMING = (0x15, 0x02, 0x49, 0x5E, 0x64, 0x73, 0x38, 0x2F,
           0xD0, 0xC7, 0x8C, 0x9B, 0xA1, 0xB6, 0xFD, 0xEA)
INTERLEAVE_GROUPS = (0, 6, 12, 20, 26, 32)


def c_round(v: float) -> int:
    """C's round(): half away from zero."""
    return int(math.floor(v + 0.5)) if v >= 0 else -int(math.floor(-v + 0.5))


def bit(v: int, i: int) -> int:
    return (v >> i) & 1


def reversed_byte(b: int) -> int:
    return sum(bit(b, i) << (7 - i) for i in range(8))


def frame_counter(frame: int) -> int:
    """The 8-bit frame counter of frame `frame` (1 the stream's first)."""
    return (frame - 1) & 0xFF


def initial_word(cw: int, counter: int) -> int:
    """The LFSRs' 60-bit load: the counter and its inverse alternately,
    four pairs, xor the control word."""
    pair = ((counter ^ 0xFF) << 8) | counter
    word = 0
    for i in range(4):
        word |= pair << (16 * i)
    return (word ^ cw) & ((1 << 60) - 1)


def prbs_frame(counter: int, c: int, cw: int = FREE_ACCESS_CW):
    """One frame of the PRBS from its counter and the output register
    `c` left by the frame before: ({line: cut byte}, `c` at its end),
    every scrambled line's byte, line 23's included."""
    word = initial_word(cw, counter)
    sr1 = word & ((1 << LFSR1_BITS) - 1)
    sr2 = (word >> LFSR1_BITS) & ((1 << LFSR2_BITS) - 1)
    cuts = {}
    for start in FIELD_STARTS:
        for line in range(start, start + LINES_PER_FIELD):
            cuts[line] = (c >> 8) & 0xFF
            for _ in range(16):
                sr1 = (sr1 >> 1) ^ (LFSR1_TAPS if sr1 & 1 else 0)
                sr2 = (sr2 >> 1) ^ (LFSR2_TAPS if sr2 & 1 else 0)
                # the multiplexer's address: LFSR 2's top five bits, its
                # bit 28 the address's least significant
                a = 0
                for i in range(5):
                    a |= bit(sr2, LFSR2_BITS - 1 - i) << i
                a = min(a, 30)
                # the selected bit: LFSR 1 counted from its top
                c = (c >> 1) | (bit(sr1, LFSR1_BITS - 1 - a) << 15)
    return cuts, c


def message(counter: int, messages=FREE_ACCESS_MESSAGES) -> list:
    """The active 32-byte message, as last reloaded at or before the
    frame with this counter (every 8th frame)."""
    msg = list(messages[((counter >> 3) & 7) % len(messages)][:31])
    msg.append((-sum(msg)) & 0xFF)
    return msg


def hamming_and_interleave(packet: list) -> bytes:
    """20 bytes -> the 40 bytes sent: each byte Hamming-coded as its high
    nibble's code then its low nibble's, then the six groups
    bit-transposed in place, in order."""
    out = []
    for b in packet:
        out += [HAMMING[b >> 4], HAMMING[b & 0x0F]]
    for g in INTERLEAVE_GROUPS:
        s = out[g:g + 8]
        s[0], s[7] = reversed_byte(s[0]), reversed_byte(s[7])
        # byte i of the result: bit (7 - i) of each of the 8 bytes, byte
        # j's in bit j
        out[g:g + 8] = [sum(bit(s[j], 7 - i) << j for j in range(8))
                        for i in range(8)]
    return bytes(out)


def vbi_packet(counter: int, mode: int = FREE_ACCESS_MODE) -> bytes:
    """The frame's 40-byte VBI packet."""
    msg = message(counter)
    seq = SEQUENCE[(counter >> 4) & 7]
    if counter & 4 == 0:
        half, head, second = msg[:16], seq, counter & 0xFF
    else:
        half, head, second = (msg[16:], ((seq >> 4) | (seq << 4)) & 0xFF,
                              mode)
    packet = []
    for first, data in ((head, half[:8]), (second, half[8:])):
        group = [first] + list(data)
        packet += group + [sum(group) & 0xFF]
    return hamming_and_interleave(packet)


def frames(f0: int, f1: int) -> dict:
    """Frames f0..f1's (VBI packet, {line: cut byte}), the PRBS started
    one frame early, at f0 - 1, to recover `c` (0 before frame 1).  Any
    `c` will do there: 16 shifts a line replace all of it, so a frame's
    last line leaves the same `c` whatever the frame began with."""
    c = 0
    if f0 > 1:
        _, c = prbs_frame(frame_counter(f0 - 1), 0)
    out = {}
    for f in range(f0, f1 + 1):
        cuts, c = prbs_frame(frame_counter(f), c)
        out[f] = (vbi_packet(frame_counter(f)), cuts)
    return out


class FreeAccessVideocrypt:
    """The line process over rows of a raster (float32 [R, W], the
    stream's lines in order; stream line k is frame 1 + k // 625's line
    k % 625 + 1)."""

    def __init__(self, params):
        p = params
        if p.conf.lines != 625:
            raise NotImplementedError("Videocrypt needs 625 lines")
        self.width, self.lines = p.width, p.conf.lines
        # the 14-MHz timing grid, from the centre of the line sync
        f = p.width / VC_WIDTH
        l0 = VC_SAMPLE_RATE * p.conf.hsync_width / 2
        self.grid = [c_round((l0 + x) * f) for x in range(VC_WIDTH)]
        # the 40 symbols' samples (upstream's vbidata LUT)
        level = c_round((p.white_level - p.black_level) * 1.00)
        swidth = p.pixel_rate / VC_SAMPLE_RATE * 18
        rise = p.pixel_rate * 375e-9
        offset = p.pixel_rate * 10.86e-6
        x = np.arange(p.width, dtype=np.float64)
        self.symbols = np.array(
            [[c_round(v) for v in rc_window(x, offset + swidth * b, swidth,
                                            rise) * level]
             for b in range(40)], dtype=np.int64)

    def segments(self, cut_byte: int) -> tuple:
        """The two moves of a scrambled line, as (first column, end
        column, the next line's first column)."""
        g = self.grid
        cut = 105 + (0xFF - cut_byte) * 2
        a, b, e = g[VC_LEFT], g[VC_LEFT + cut], g[VC_RIGHT + VC_OVERLAP]
        return (a, b, g[VC_LEFT + 710 - cut]), (b, e, a)

    def process(self, rows: torch.Tensor, k_first: int) -> torch.Tensor:
        """Rows for stream lines k_first, k_first + 1, ... after the line
        process, but for the last row, which is only read (the next line
        of the one before it): float32 [R - 1, W]."""
        R = rows.shape[0] - 1
        ks = [k for k in range(k_first, k_first + R) if k >= 0]
        out = rows[:R].clone()
        if not ks:
            return out
        state = frames(1 + ks[0] // self.lines, 1 + ks[-1] // self.lines)
        # scrambled lines grouped by cut byte, VBI lines with their bytes
        by_cut: dict = {}
        vbi_rows, vbi_bytes = [], []
        for k in ks:
            frame, line = 1 + k // self.lines, k % self.lines + 1
            packet, cuts = state[frame]
            for i, start in enumerate(VBI_FIELD_STARTS):
                if start <= line < start + VBI_LINES_PER_FIELD:
                    j = (line - start + i * VBI_LINES_PER_FIELD) \
                        * VBI_BYTES_PER_LINE
                    vbi_rows.append(k - k_first)
                    vbi_bytes.append(packet[j:j + VBI_BYTES_PER_LINE])
            if line in cuts and line != WSS_LINE:
                by_cut.setdefault(cuts[line], []).append(k - k_first)
        dev = rows.device
        for cut_byte, rs in by_cut.items():
            r = torch.tensor(rs, device=dev)
            for x0, x1, y0 in self.segments(cut_byte):
                out[r, x0:x1] = rows[r + 1, y0:y0 + (x1 - x0)]
        if vbi_rows:
            bits = np.array([[bit(b[i // 8], i % 8) for i in range(40)]
                             for b in vbi_bytes], dtype=np.int64)
            burst = torch.as_tensor(bits @ self.symbols, device=dev)
            r = torch.tensor(vbi_rows, device=dev)
            out[r] = out[r] + burst.to(out.dtype)
        return out
