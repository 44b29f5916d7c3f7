"""Videocrypt I/II conditional-access scrambler (src/videocrypt.c; port of
hacktv_tpu/services/videocrypt.py).

Line cut-and-rotate for 625-line PAL: each scrambled output line N carries
the content of source line N+1 rotated about a per-line cut point derived
from a dual-LFSR + multiplexer PRBS seeded per frame from the 60-bit
control word.  VBI activation messages (Hamming-coded, 8x8 interleaved)
occupy 8 lines per frame.

All bit/PRBS work runs on the host per frame (tiny, sequential; the cut
bytes through the native runtime's `rt_vc_clock16`, whose plain Python
version is `_VCState._clock16`); the device takes per-line cut columns
and rotates a whole block of lines with one gather, and renders all VBI
bursts with one product against the pulse-shaped symbol basis
(services/vbidata.py).

The host coder is measured (telemetry.py): `block_arrays` is the span
`dispatch.audio.services.videocrypt` while tracing, and counts always
`videocrypt.host_ns` (its time, two perf_counter_ns a block),
`videocrypt.blocks`, `videocrypt.frames` (frames of PRBS and VBI state
generated) and `videocrypt.cut_lines` (lines the block rotates).  It runs
on the host for every block, whether the step then replays as a CUDA
graph or not, so these keep measuring under the graphs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import runtime, telemetry
from . import vbidata

# ---------------------------------------------------------------------------
# Constants (src/videocrypt.h:24-50)

VC_SAMPLE_RATE = 14_000_000
VC_WIDTH = VC_SAMPLE_RATE // 25 // 625          # 896
VC_VBI_FIELD_1_START = 12
VC_VBI_FIELD_2_START = 325
VC_VBI_LINES_PER_FIELD = 4
VC_LEFT = 120
VC_RIGHT = VC_LEFT + 710
VC_OVERLAP = 15
VC_FIELD_1_START = 23
VC_FIELD_2_START = 335
VC_LINES_PER_FIELD = 287
# lines whose iteration clocks the PRBS, in output order
# (src/videocrypt.c:446-483)
_CUT_LINES = np.array(
    [l for l in range(1, 626)
     if VC_FIELD_1_START <= l < VC_FIELD_1_START + VC_LINES_PER_FIELD
     or VC_FIELD_2_START <= l < VC_FIELD_2_START + VC_LINES_PER_FIELD],
    dtype=np.int64)
VC_PRBS_CW_FA = (1 << 60) - 1
VC2_VBI_FIELD_1_START = VC_VBI_FIELD_1_START - 4
VC2_VBI_FIELD_2_START = VC_VBI_FIELD_2_START - 4

# Packet header sequences (src/videocrypt.c:49-55)
_SEQUENCE = (0x87, 0x96, 0xA5, 0xB4, 0xC3, 0xD2, 0xE1, 0x87)
_SEQUENCE2 = (0x80, 0x91, 0xA2, 0xB3, 0xC4, 0xD5, 0xE6, 0xF7)

# Hamming codes (src/videocrypt.c:58-61)
_HAMMING = (0x15, 0x02, 0x49, 0x5E, 0x64, 0x73, 0x38, 0x2F,
            0xD0, 0xC7, 0x8C, 0x9B, 0xA1, 0xB6, 0xFD, 0xEA)

# VC1 free-access block (src/videocrypt.c:64)
_FA_BLOCKS = ({"mode": 0x05, "codeword": VC_PRBS_CW_FA,
               "messages": [[0] * 32] * 7},)

# VC1 conditional-access sample blocks, from MTV UK, requires an active Sky
# card to decode (src/videocrypt.c:68-95)
_MTV_BLOCKS = (
    {"mode": 0x07, "codeword": 0xB2DD55A7BCE178E,
     "messages": [
         [0x20] + [0] * 31,
         [0] * 32, [0] * 32, [0] * 32, [0] * 32, [0] * 32,
         [0xF8, 0x19, 0x10, 0x83, 0x20, 0x85, 0x60, 0xAF, 0x8F, 0xF0,
          0x49, 0x34, 0x86, 0xC4, 0x6A, 0xCA, 0xC3, 0x21, 0x4D, 0x44,
          0xB3, 0x24, 0x36, 0x57, 0xEC, 0xA7, 0xCE, 0x12, 0x38, 0x91,
          0x3E, 0x00],
     ]},
    {"mode": 0x07, "codeword": 0xF9885DA50770B80,
     "messages": [
         [0x20, 0x00, 0x69, 0x20, 0x20, 0x20, 0x48, 0x41, 0x43, 0x4B,
          0x54, 0x56] + [0] * 20,
         [0] * 32, [0] * 32, [0] * 32, [0] * 32, [0] * 32,
         [0xF8, 0x19, 0x10, 0x83, 0x20, 0xD1, 0xB5, 0xA9, 0x1F, 0x82,
          0xFE, 0xB3, 0x6B, 0x0A, 0x82, 0xC3, 0x30, 0x7B, 0x65, 0x9C,
          0xF2, 0xBD, 0x5C, 0xB0, 0x6A, 0x3B, 0x64, 0x0F, 0xA2, 0x66,
          0xBB, 0x00],
     ]},
)

# VC2 free-access block (src/videocrypt.c:98)
_FA2_BLOCKS = ({"mode": 0x9C, "codeword": VC_PRBS_CW_FA,
                "messages": [[0] * 32] * 8},)


def _reverse8(b: int) -> int:
    b = (b & 0xF0) >> 4 | (b & 0x0F) << 4
    b = (b & 0xCC) >> 2 | (b & 0x33) << 2
    b = (b & 0xAA) >> 1 | (b & 0x55) << 1
    return b


_REV8 = [int(format(i, "08b")[::-1], 2) for i in range(256)]


def _rev(b: int, x: int) -> int:
    r = (_REV8[b & 0xFF] << 24) | (_REV8[(b >> 8) & 0xFF] << 16) \
        | (_REV8[(b >> 16) & 0xFF] << 8) | _REV8[(b >> 24) & 0xFF]
    return r >> (32 - x)


def _rnibble(a: int) -> int:
    return ((a >> 4) | (a << 4)) & 0xFF


def _generate_iw(cw: int, fcnt: int) -> int:
    """IW = CW xor (FCNT repeated 8x, alternately inverted)
    (src/videocrypt.c:131-140)."""
    iw = ((fcnt ^ 0xFF) << 8) | fcnt
    iw |= (iw << 16) | (iw << 32) | (iw << 48)
    return (iw ^ cw) & ((1 << 60) - 1)


def _interleave(frame: bytearray) -> None:
    """8x8 bit-transpose interleave of six 8-byte groups
    (src/videocrypt.c:143-168)."""
    for off in (0, 6, 12, 20, 26, 32):
        s = frame[off:off + 8]
        s[0] = _reverse8(s[0])
        s[7] = _reverse8(s[7])
        r = bytearray(8)
        for i in range(8):
            m = 0x80 >> i
            v = 0
            for j in range(8):
                v |= (1 if (s[j] & m) else 0) << j
            r[i] = v
        frame[off:off + 8] = r


def _encode_vbi(data16, a: int, b: int) -> bytes:
    """One frame's 40-byte VBI block: two CRC'd 10-byte halves, nibble
    Hamming expansion, interleave (src/videocrypt.c:171-199)."""
    vbi = bytearray(40)
    crc = vbi[0] = a & 0xFF
    for x in range(8):
        vbi[1 + x] = data16[x] & 0xFF
        crc = (crc + vbi[1 + x]) & 0xFF
    vbi[9] = crc
    crc = vbi[10] = b & 0xFF
    for x in range(8):
        vbi[11 + x] = data16[8 + x] & 0xFF
        crc = (crc + vbi[11 + x]) & 0xFF
    vbi[19] = crc
    for x in range(19, -1, -1):
        vbi[x * 2 + 1] = _HAMMING[vbi[x] & 0x0F]
        vbi[x * 2 + 0] = _HAMMING[vbi[x] >> 4]
    _interleave(vbi)
    return bytes(vbi)


class _VCState:
    """Sequential per-frame generator of VBI bytes and per-line cut bytes,
    mirroring the counter/PRBS state flow of vc_render_line
    (src/videocrypt.c:289-509)."""

    def __init__(self, blocks, blocks2):
        self.blocks = blocks
        self.blocks2 = blocks2
        self.counter = 0
        self.cw = VC_PRBS_CW_FA
        self.block = 0
        self.block2 = 0
        self.message = [0] * 32
        self.message2 = [0] * 32
        self.vbi = bytes(40)
        self.vbi2 = bytes(40)
        self.sr1 = 0
        self.sr2 = 0
        self.c = 0
        self._frames: dict[int, tuple] = {}
        self._next_frame = 1

    def _clock16(self) -> int:
        """Cut byte for this line, then 16 PRBS shifts
        (src/videocrypt.c:456-472): the plain version of
        runtime.vc_clock16, which the encoder calls."""
        x = (self.c >> 8) & 0xFF
        sr1, sr2, c = self.sr1, self.sr2, self.c
        for _ in range(16):
            sr1 = (sr1 >> 1) ^ (0x7BB88888 if sr1 & 1 else 0)
            sr2 = (sr2 >> 1) ^ (0x17A2C100 if sr2 & 1 else 0)
            a = _rev(sr2, 29) & 0x1F
            if a == 31:
                a = 30
            c = (c >> 1) | (((_rev(sr1, 31) >> a) & 1) << 15)
        self.sr1, self.sr2, self.c = sr1, sr2, c
        return x

    def _gen_next_frame(self):
        fr = self._next_frame
        # --- line 1: regenerate VBI + reset PRBS (videocrypt.c:296-409)
        if self.blocks:
            if (self.counter & 7) == 0:
                msg = self.blocks[self.block]["messages"][
                    ((self.counter >> 3) & 7) % 7]
                crc = 0
                for x in range(31):
                    self.message[x] = msg[x]
                    crc = (crc + msg[x]) & 0xFF
                self.message[31] = (-crc) & 0xFF
            if (self.counter & 4) == 0:
                self.vbi = _encode_vbi(self.message[:16],
                                       _SEQUENCE[(self.counter >> 4) & 7],
                                       self.counter & 0xFF)
            else:
                self.vbi = _encode_vbi(
                    self.message[16:],
                    _rnibble(_SEQUENCE[(self.counter >> 4) & 7]),
                    self.blocks[self.block]["mode"])
        if self.blocks2:
            if (self.counter & 1) == 0:
                msg = self.blocks2[self.block2]["messages"][
                    (self.counter >> 1) & 7]
                crc = 0
                for x in range(31):
                    self.message2[x] = msg[x]
                    crc = (crc + msg[x]) & 0xFF
                self.message2[31] = (-crc) & 0xFF
                self.vbi2 = _encode_vbi(self.message2[:16],
                                        _SEQUENCE2[(self.counter >> 1) & 7],
                                        self.counter & 0xFF)
            else:
                self.vbi2 = _encode_vbi(
                    self.message2[16:],
                    _rnibble(_SEQUENCE2[(self.counter >> 1) & 7]),
                    0x00 if self.counter & 0x08
                    else self.blocks2[self.block2]["mode"])

        iw = _generate_iw(self.cw, self.counter & 0xFF)
        self.sr1 = iw & ((1 << 31) - 1)
        self.sr2 = (iw >> 31) & ((1 << 29) - 1)
        self.counter = (self.counter + 1) & 0xFF

        if (self.counter & 0x3F) == 0:
            if self.blocks:
                self.cw = self.blocks[self.block]["codeword"]
            self.block = (self.block + 1) % max(len(self.blocks), 1)
        if (self.counter & 0x0F) == 0:
            if self.blocks2:
                self.cw = self.blocks2[self.block2]["codeword"]
            self.block2 = (self.block2 + 1) % max(len(self.blocks2), 1)

        # --- per-line cut bytes for lines 1..625, in output order
        cuts = np.full(626, -1, dtype=np.int32)
        st = np.array([self.sr1, self.sr2, self.c], dtype=np.uint64)
        xs = runtime.vc_clock16(st, len(_CUT_LINES))
        self.sr1, self.sr2, self.c = int(st[0]), int(st[1]), int(st[2])
        cuts[_CUT_LINES] = xs
        cuts[23] = -1                   # WSS hack (videocrypt.c:483)
        self._frames[fr] = (self.vbi, self.vbi2, cuts)
        self._frames.pop(fr - 8, None)
        self._next_frame += 1
        telemetry.count("videocrypt.frames")

    def frame(self, fr: int):
        while fr >= self._next_frame:
            self._gen_next_frame()
        return self._frames[fr]


class Videocrypt:
    """Batched Videocrypt I/II line process."""

    STATICS = ("basis",)
    _CKPT_ATTRS = ("state",)

    def __init__(self, params, mode: str | None = None,
                 mode2: str | None = None, device="cuda"):
        p = params
        if p.conf.lines != 625:
            raise ValueError("videocrypt: requires a 625-line mode")
        modes1 = {None: None, "free": _FA_BLOCKS, "conditional": _MTV_BLOCKS}
        modes2 = {None: None, "free": _FA2_BLOCKS}
        if mode not in modes1:
            raise ValueError(f"videocrypt: unrecognised mode {mode!r}")
        if mode2 not in modes2:
            raise ValueError(f"videocrypt2: unrecognised mode {mode2!r}")
        self.blocks = modes1[mode]
        self.blocks2 = modes2[mode2]
        self.state = _VCState(self.blocks or (), self.blocks2 or ())
        self.lines_total = p.conf.lines
        self.width = p.width

        # VBI burst basis: 40 flat-top symbols at 18/14MHz-scaled timing
        # (src/videocrypt.c:209-216)
        level = round((p.white_level - p.black_level) * 1.00)
        self.basis = vbidata.basis_step(
            40, p.width, level,
            p.pixel_rate / VC_SAMPLE_RATE * 18,
            p.pixel_rate * 375e-9,
            p.pixel_rate * 10.86e-6)

        # Videocrypt timings are against the centre of the hsync pulse
        # (src/videocrypt.c:269-279)
        f = p.width / VC_WIDTH
        l0 = VC_SAMPLE_RATE * p.conf.hsync_width / 2
        self.video_scale = np.round(
            (l0 + np.arange(VC_WIDTH)) * f).astype(np.int64)
        self.col_a = int(self.video_scale[VC_LEFT])
        self.col_e = int(self.video_scale[VC_RIGHT + VC_OVERLAP])
        self.device = torch.device(device)
        self.upload()

    def upload(self):
        """The basis and the column grid on the device."""
        self.d_basis = torch.as_tensor(self.basis, device=self.device)
        cols = torch.arange(self.width, dtype=torch.int64,
                            device=self.device)
        self.d_cols = cols[None, :]
        self.d_window = ((cols >= self.col_a)
                         & (cols < self.col_e))[None, :]

    def block_arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        """The host arrays of rows k0 .. k0 + nlines - 1 (`_arrays`),
        timed and counted (the module's docstring)."""
        t0 = time.perf_counter_ns()
        with telemetry.span("dispatch.audio.services.videocrypt"):
            out = self._arrays(k0, nlines, claimed)
        telemetry.count("videocrypt.host_ns", time.perf_counter_ns() - t0)
        telemetry.count("videocrypt.blocks")
        telemetry.count("videocrypt.cut_lines",
                        int(np.count_nonzero(out["active"])))
        return out

    def _arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        """Vectorised per frame: cut-point columns and VBI byte rows
        come from array indexing per frame segment."""
        ks = k0 + np.arange(nlines, dtype=np.int64)
        valid = ks >= 0
        lines = np.where(valid, ks % self.lines_total + 1, 0)
        frames = np.where(valid, 1 + ks // self.lines_total, 0)
        packed = np.zeros((nlines, 5), dtype=np.uint8)
        active = np.zeros(nlines, dtype=np.float32)
        b_col = np.zeros(nlines, dtype=np.int32)
        s1_col = np.zeros(nlines, dtype=np.int32)
        vs = self.video_scale
        ranges = []
        if self.blocks:
            ranges += [("vbi", VC_VBI_FIELD_1_START, 0),
                       ("vbi", VC_VBI_FIELD_2_START,
                        VC_VBI_LINES_PER_FIELD)]
        if self.blocks2:
            ranges += [("vbi2", VC2_VBI_FIELD_1_START, 0),
                       ("vbi2", VC2_VBI_FIELD_2_START,
                        VC_VBI_LINES_PER_FIELD)]
        if valid.any():
            for f in range(int(frames[valid].min()),
                           int(frames.max()) + 1):
                vbi, vbi2, cuts = self.state.frame(f)
                m = valid & (frames == f)
                bufs = {"vbi": vbi, "vbi2": vbi2}
                for which, start, off in ranges:
                    sel = m & (lines >= start) \
                        & (lines < start + VC_VBI_LINES_PER_FIELD)
                    if sel.any():
                        idx = np.nonzero(sel)[0]
                        vb = np.frombuffer(bytes(bufs[which]),
                                           np.uint8).reshape(-1, 5)
                        packed[idx] = vb[lines[idx] - start + off]
                        if claimed is not None:
                            claimed[idx] = True
                x = np.asarray(cuts, dtype=np.int64)[lines]
                act = m & (x >= 0)
                if act.any():
                    idx = np.nonzero(act)[0]
                    cut = 105 + (0xFF - x[idx]) * 2
                    active[idx] = 1.0
                    b_col[idx] = vs[VC_LEFT + cut]
                    s1_col[idx] = vs[VC_LEFT + (710 - cut)]
        if claimed is not None:
            claimed[np.nonzero(valid & (lines == 335))[0]] = True
        return {"vbi_packed": packed, "active": active, "b_col": b_col,
                "s1_col": s1_col}

    def apply(self, out, arrays, lut=None):
        """Device: rotate the scrambled lines (the source is the next line),
        then add the VBI bursts."""
        # delay line: row i sources row i+1 (the bottom halo row keeps its
        # own content; it is scrambled as a real row of the next block)
        delay = torch.cat([out[1:], out[-1:]], dim=0)
        cols = self.d_cols
        b = arrays["b_col"].to(torch.int64)[:, None]
        s1 = arrays["s1_col"].to(torch.int64)[:, None]
        src = torch.where(cols < b, s1 + (cols - self.col_a),
                          self.col_a + (cols - b))
        src = src.clamp(0, out.shape[1] - 1)
        rot = torch.gather(delay, 1, src)
        # the 0/1 blend out * (1 - mask) + rot * mask, as a select
        mask = self.d_window & (arrays["active"] > 0)[:, None]
        out = torch.where(mask, rot, out)
        bits = vbidata.device_unpack_bits(arrays["vbi_packed"], 40)
        return out + vbidata.render(bits, self.d_basis)
