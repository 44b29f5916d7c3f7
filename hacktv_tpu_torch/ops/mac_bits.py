"""D/D2-MAC bit-domain coders (host side).

Port of hacktv_tpu/ops/mac_bits.py, numpy as there.  Everything here
reproduces the reference's packet/framing bit streams exactly (src/mac.c)
so the duobinary waveform synthesis can treat lines as plain bit arrays.
These are tiny, inherently serial bit operations: they run on the host
ahead of the batched waveform synthesis on the device.

The PRBS1/PRBS2 keystreams and the packet encoder go through the native
runtime (`rt_mac_prbs1`, `rt_mac_prbs2`, `rt_mac_encode_packet`), which
raises if it does not load.  Their plain Python versions stay beside them
(`native=False`) as what the tests hold the native calls against.

Bit arrays are numpy uint8 vectors in *transmission order* (the
reference packs LSB-first into bytes; we keep them flat).
"""

from __future__ import annotations

import numpy as np

from .. import runtime

MAC_WIDTH = 1296
MAC_LINES = 625
MAC_PACKET_BITS = 751
MAC_PAYLOAD_BYTES = 91

# MAC sync codes (src/mac.c:28-32)
MAC_CLAMP = 0xEAF3927F
MAC_LSW = 0x0B
MAC_CRI = 0x55555555
MAC_FSW = 0x65AEF3153F41C246

_PRBS_POLY = 0x7FFF

# Hamming codes (src/mac.c:38-40)
HAMMING = np.array([0x15, 0x02, 0x49, 0x5E, 0x64, 0x73, 0x38, 0x2F,
                    0xD0, 0xC7, 0x8C, 0x9B, 0xA1, 0xB6, 0xFD, 0xEA],
                   dtype=np.uint8)

_NWO = b"hacktv"
_NWNAME = b"hacktv"
_SNAME = b"hacktv"


# ----------------------------------------------------------------------
# bit packing helpers

def bits_lsb(value: int, nbits: int) -> np.ndarray:
    """`_bits` (src/mac.c:364-376): LSB first."""
    value = int(value)
    return np.array([(value >> i) & 1 for i in range(nbits)],
                    dtype=np.uint8)


def rbits_msb(value: int, nbits: int) -> np.ndarray:
    """`_rbits` (src/mac.c:379-392): MSB first."""
    value = int(value)
    return np.array([(value >> i) & 1 for i in range(nbits - 1, -1, -1)],
                    dtype=np.uint8)


def bytes_to_bits_lsb(data) -> np.ndarray:
    """`_bits_buf`: bytes unpacked LSB-first per byte."""
    a = np.frombuffer(bytes(data), dtype=np.uint8)
    return np.unpackbits(a, bitorder="little")


def bits_to_bytes_lsb(bits: np.ndarray) -> bytes:
    pad = (-len(bits)) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def parity(value: int) -> int:
    return bin(value).count("1") & 1


# ----------------------------------------------------------------------
# PRBS generator for spectrum shaping (src/mac.c:256-264)
#
# 15-bit LFSR: b = (x ^ (x >> 14)) & 1; x = (x >> 1) | (b << 14).
# Full period 32767; we precompute the output bit sequence once and map
# any seed to a position, making whole-line whitening sequences plain
# slices.

class Prbs15:
    def __init__(self):
        n = 32767
        states = np.empty(n, dtype=np.int64)
        outs = np.empty(n, dtype=np.uint8)
        x = _PRBS_POLY
        for i in range(n):
            states[i] = x
            b = (x ^ (x >> 14)) & 1
            outs[i] = b
            x = (x >> 1) | (b << 14)
        assert x == _PRBS_POLY, "PRBS15 period is not 32767"
        self.outs = np.concatenate([outs, outs])  # wrap margin
        self.pos = {int(s): i for i, s in enumerate(states)}
        self.states = states

    def seq(self, seed: int, nbits: int) -> np.ndarray:
        """Output bits from `seed`, advancing it."""
        p = self.pos[seed]
        if nbits <= 32767:
            return self.outs[p:p + nbits]
        reps = np.tile(self.outs[:32767], nbits // 32767 + 2)
        return reps[p:p + nbits]

    def advance(self, seed: int, nbits: int) -> int:
        return int(self.states[(self.pos[seed] + nbits) % 32767])


_PRBS15 = None


def prbs15() -> Prbs15:
    global _PRBS15
    if _PRBS15 is None:
        _PRBS15 = Prbs15()
    return _PRBS15


def line_prbs_seeds(mac_mode_d: bool) -> np.ndarray:
    """Per-line PRBS seeds (src/mac.c:943-954).

    Line i's seed is line i-1's advanced by 1296 (D) / 648 (D2) bits.
    """
    g = prbs15()
    step = 1296 if mac_mode_d else 648
    seeds = np.empty(MAC_LINES, dtype=np.int64)
    seeds[0] = _PRBS_POLY
    for i in range(1, MAC_LINES):
        seeds[i] = g.advance(int(seeds[i - 1]), step)
    return seeds


# ----------------------------------------------------------------------
# CA PRBS generators (src/mac.c:267-361, 605-638)

PRBS_CW_FA = (1 << 60) - 1


_REV8 = [int(format(i, "08b")[::-1], 2) for i in range(256)]


def _rev(b: int, x: int) -> int:
    # byte-table bit reversal (hot: the PRBS1 update reverses two shift
    # registers per output bit, 61 bits per packet)
    if x > 32:
        r = 0
        for i in range(8):
            r = (r << 8) | _REV8[(b >> (8 * i)) & 0xFF]
        return r >> (64 - x)
    r = (_REV8[b & 0xFF] << 24) | (_REV8[(b >> 8) & 0xFF] << 16) \
        | (_REV8[(b >> 16) & 0xFF] << 8) | _REV8[(b >> 24) & 0xFF]
    return r >> (32 - x)


_REV8_ARR = np.array(_REV8, dtype=np.int64)


def _rev_arr(b: np.ndarray, x: int) -> np.ndarray:
    r = ((_REV8_ARR[b & 0xFF] << 24) | (_REV8_ARR[(b >> 8) & 0xFF] << 16)
         | (_REV8_ARR[(b >> 16) & 0xFF] << 8)
         | _REV8_ARR[(b >> 24) & 0xFF])
    return r >> (32 - x)


def prbs_generate_iw(cw: int, fcnt: int) -> int:
    """(src/mac.c:267-276): FCNT repeated 8 times, alternately inverted."""
    fcnt &= 0xFF
    iw = ((fcnt ^ 0xFF) << 8) | fcnt
    iw |= (iw << 16) | (iw << 32) | (iw << 48)
    return (iw ^ cw) & ((1 << 60) - 1)


class CaPrbs1:
    """Packet-scrambling IW generator PRBS1 (src/mac.c:279-285, 310-336).
    `native`: codes come from `rt_mac_prbs1`; False runs the Python
    recurrence (the plain version)."""

    def __init__(self, native: bool = True):
        self.native = native
        self.sr1 = 0
        self.sr2 = 0
        self._buf = None
        self._bi = 0

    def reset(self, cw: int, fcnt: int):
        iw = prbs_generate_iw(cw, fcnt)
        self.sr1 = iw & ((1 << 31) - 1)
        self.sr2 = (iw >> 31) & ((1 << 29) - 1)
        self._buf = None

    def update(self) -> int:
        if self.native:
            lib = runtime.load()
            # batch-generate ahead: codes are consumed in call order and
            # any surplus is discarded on the next reset()
            if self._buf is None or self._bi >= len(self._buf):
                st = np.array([self.sr1, self.sr2], dtype=np.uint64)
                out = np.empty(96, dtype=np.uint64)
                lib.rt_mac_prbs1(st.ctypes.data, 96, out.ctypes.data)
                self.sr1, self.sr2 = int(st[0]), int(st[1])
                self._buf, self._bi = out, 0
            v = int(self._buf[self._bi])
            self._bi += 1
            return v
        # generate the 61 LFSR states with cheap int steps, then derive
        # the output bits vectorised (the reversals and muxes were the
        # hot path at ~80 packets/frame)
        sr1, sr2 = self.sr1, self.sr2
        s1 = np.empty(61, np.int64)
        s2 = np.empty(61, np.int64)
        for i in range(61):
            s1[i] = sr1
            s2[i] = sr2
            sr1 = (sr1 >> 1) ^ (0x78810820 if sr1 & 1 else 0)
            sr2 = (sr2 >> 1) ^ (0x17121100 if sr2 & 1 else 0)
        self.sr1, self.sr2 = sr1, sr2
        r1 = _rev_arr(s1, 31)
        r2 = _rev_arr(s2, 29)
        a = (r2 & 0x03) | ((r1 << 2) & 0x1C)
        b = ((r2 >> 2) & 0x000000FF) | ((r1 << 5) & 0xFFFFFF00)
        bits = (b >> a) & 1
        code = 0
        for i in range(60, -1, -1):
            code = (code << 1) | int(bits[i])
        return code

    def take(self, n: int) -> np.ndarray:
        """Drain n IW codes in bulk (one native call for the tail
        instead of n update() round-trips)."""
        out = np.empty(n, dtype=np.uint64)
        i = 0
        while i < n:
            if self._buf is None or self._bi >= len(self._buf):
                if not self.native:
                    for j in range(i, n):
                        out[j] = self.update()
                    return out
                lib = runtime.load()
                want = max(96, n - i)
                st = np.array([self.sr1, self.sr2], dtype=np.uint64)
                buf = np.empty(want, dtype=np.uint64)
                lib.rt_mac_prbs1(st.ctypes.data, want, buf.ctypes.data)
                self.sr1, self.sr2 = int(st[0]), int(st[1])
                self._buf, self._bi = buf, 0
            c = min(n - i, len(self._buf) - self._bi)
            out[i:i + c] = self._buf[self._bi:self._bi + c]
            self._bi += c
            i += c
        return out


class CaPrbs2:
    """Vision-scrambling cut-point generator PRBS2 (src/mac.c:287-293,
    339-361).  `native` as for CaPrbs1 (`rt_mac_prbs2`)."""

    def __init__(self, native: bool = True):
        self.native = native
        self.sr3 = 0
        self.sr4 = 0
        self._buf = None
        self._bi = 0

    def reset(self, cw: int, fcnt: int):
        iw = prbs_generate_iw(cw, fcnt)
        self.sr3 = iw & ((1 << 31) - 1)
        self.sr4 = (iw >> 31) & ((1 << 29) - 1)
        self._buf = None

    def update(self) -> int:
        if self.native:
            lib = runtime.load()
            if self._buf is None or self._bi >= len(self._buf):
                st = np.array([self.sr3, self.sr4], dtype=np.uint64)
                out = np.empty(128, dtype=np.uint16)
                lib.rt_mac_prbs2(st.ctypes.data, 128, out.ctypes.data)
                self.sr3, self.sr4 = int(st[0]), int(st[1])
                self._buf, self._bi = out, 0
            v = int(self._buf[self._bi])
            self._bi += 1
            return v
        code = 0
        sr3, sr4 = self.sr3, self.sr4
        for _ in range(16):
            a = _rev(sr4, 29) & 0x1F
            if a == 31:
                a = 30
            code = (code >> 1) | (((_rev(sr3, 31) >> a) & 1) << 15)
            sr3 = (sr3 >> 1) ^ (0x7BB88888 if sr3 & 1 else 0)
            sr4 = (sr4 >> 1) ^ (0x17A2C100 if sr4 & 1 else 0)
        self.sr3, self.sr4 = sr3, sr4
        return code

    def take(self, n: int) -> np.ndarray:
        """Drain n cut-point codes in bulk."""
        out = np.empty(n, dtype=np.uint16)
        i = 0
        while i < n:
            if self._buf is None or self._bi >= len(self._buf):
                if not self.native:
                    for j in range(i, n):
                        out[j] = self.update()
                    return out
                lib = runtime.load()
                want = max(128, n - i)
                st = np.array([self.sr3, self.sr4], dtype=np.uint64)
                buf = np.empty(want, dtype=np.uint16)
                lib.rt_mac_prbs2(st.ctypes.data, want, buf.ctypes.data)
                self.sr3, self.sr4 = int(st[0]), int(st[1])
                self._buf, self._bi = buf, 0
            c = min(n - i, len(self._buf) - self._bi)
            out[i:i + c] = self._buf[self._bi:self._bi + c]
            self._bi += c
            i += c
        return out


def scramble_packet(pkt: bytearray, iw: int):
    """PRBS3 packet payload scrambler (src/mac.c:605-638); `pkt` is the
    91-byte payload, byte 0 (PT) untouched."""
    for x in range(1, MAC_PAYLOAD_BYTES):
        c = 0
        for _ in range(8):
            r = _rev(iw, 61)
            a = (((r >> 4) & 1) | (((r >> 9) & 1) << 1) |
                 (((r >> 14) & 1) << 2) | (((r >> 19) & 1) << 3) |
                 (((r >> 24) & 1) << 4))
            b = (r >> 29) & 0xFFFFFFFF
            c = (c >> 1) | (((b >> a) & 1) << 7)
            iw = (iw >> 1) ^ (0x163D23594C934051 if iw & 1 else 0)
        pkt[x] ^= c


# ----------------------------------------------------------------------
# Error-protection codes

def crc16(data: bytes) -> int:
    """Reversed CCITT CRC (src/mac.c:439-456)."""
    crc = 0
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
    return crc


def bch_encode(bits: np.ndarray, n: int, k: int) -> np.ndarray:
    """Append BCH parity to a LSB-first bit array (src/mac.c:464-483).

    bits[:k] is the data; returns an n-bit array.
    """
    g = 0x0571 if n == 23 else 0x3BB0
    code = 0
    for i in range(k):
        b = (int(bits[i]) ^ code) & 1
        code >>= 1
        if b:
            code ^= g
    out = np.zeros(n, dtype=np.uint8)
    out[:k] = bits[:k]
    out[k:n] = bits_lsb(code, n - k)
    return out


_BCH_REM = {}


def _bch_rem_table(n: int, k: int) -> np.ndarray:
    """Remainder of each unit input bit through the BCH LFSR.  The
    division loop in bch_encode is linear over GF(2), so the code word
    of any input is the XOR of the unit remainders of its set bits."""
    tab = _BCH_REM.get((n, k))
    if tab is None:
        g = 0x0571 if n == 23 else 0x3BB0
        tab = np.zeros(k, dtype=np.int64)
        # remainder of e_{k-1} is g itself; each earlier unit bit goes
        # through one more LFSR step c -> (c >> 1) ^ (c & 1 ? g : 0)
        c = g
        tab[k - 1] = c
        for j in range(k - 2, -1, -1):
            c = (c >> 1) ^ (g if c & 1 else 0)
            tab[j] = c
        _BCH_REM[(n, k)] = tab
    return tab


def bch_encode_batch(bits: np.ndarray, n: int, k: int) -> np.ndarray:
    """Vectorised bch_encode over a [F, k] LSB-first bit matrix;
    returns [F, n] (src/mac.c:464-483)."""
    tab = _bch_rem_table(n, k)
    codes = np.bitwise_xor.reduce(
        np.where(bits[:, :k] != 0, tab[None, :], 0), axis=1)
    out = np.zeros((bits.shape[0], n), dtype=np.uint8)
    out[:, :k] = bits[:, :k]
    out[:, k:n] = (codes[:, None] >> np.arange(n - k)[None, :]) & 1
    return out


def golay_encode(data: bytes, blocks: int) -> bytes:
    """Golay(24,12) via paired BCH(23,12)+parity (src/mac.c:486-513).

    Input: ceil(blocks*1.5) bytes of packed 12-bit values; output
    blocks*3 bytes.
    """
    src = bytearray(data)
    out = bytearray()
    for i in range(0, blocks, 2):
        s = src[(i // 2) * 3:(i // 2) * 3 + 3]
        while len(s) < 3:
            s.append(0)
        for val12 in (s[0] | ((s[1] & 0x0F) << 8),
                      (s[1] >> 4) | (s[2] << 4)):
            b = bch_encode(bits_lsb(val12, 12), 23, 12)
            word = int(np.packbits(np.concatenate(
                [b, np.zeros(1, dtype=np.uint8)]),
                bitorder="little").view(np.uint8)[0])
            by = bits_to_bytes_lsb(b)
            w = by[0] | (by[1] << 8) | (by[2] << 16)
            p = (parity(w) ^ 1) << 7
            out += bytes([by[0], by[1], by[2] | p])
    return bytes(out[:blocks * 3])


# ----------------------------------------------------------------------
# Packet encoding (src/mac.c:567-603)

def _interleave_perm() -> np.ndarray:
    """The 752-bit packet interleave as a permutation: output bit
    8*d + j = input bit j*94 + d (derivation of src/mac.c:567-584)."""
    d = np.arange(94)
    j = np.arange(8)
    perm = np.empty(752, dtype=np.int64)
    perm[(d[:, None] * 8 + j[None, :]).ravel()] = \
        (j[None, :] * 94 + d[:, None]).ravel()
    return perm


_INTERLEAVE = _interleave_perm()


def encode_packet(address: int, continuity: int, payload: bytes | None
                  ) -> np.ndarray:
    """751-bit interleaved packet (src/mac.c:586-603) as a bit array in
    transmission order (LSB-first within bytes, like the reference's
    consumption in `_line`)."""
    bits = np.zeros(752, dtype=np.uint8)
    hdr = np.zeros(23, dtype=np.uint8)
    hdr[:10] = bits_lsb(address & 0x3FF, 10)
    hdr[10:12] = bits_lsb(continuity & 3, 2)
    bits[:23] = bch_encode(hdr, 23, 12)
    if payload is not None:
        pb = bytes_to_bits_lsb(payload)
        bits[23:23 + min(len(pb), 728)] = pb[:728]
    # interleave includes one extra (zero) bit to shift the final byte
    return bits[_INTERLEAVE][:751]


def encode_packet_fast(address: int, continuity: int,
                       payload: bytes | None, scramble: bool,
                       iw: int, native: bool = True) -> np.ndarray:
    """encode_packet with the optional PRBS3 payload scramble folded in,
    through `rt_mac_encode_packet` (src/mac.c:586-638); `native=False`,
    or a scrambled payload that is not 91 bytes, takes the Python
    version."""
    if not native or (scramble and payload is not None
                      and len(payload) != MAC_PAYLOAD_BYTES):
        if scramble and payload is not None:
            pb = bytearray(payload)
            scramble_packet(pb, iw)
            payload = bytes(pb)
        return encode_packet(address, continuity, payload)
    lib = runtime.load()
    out = np.empty(751, dtype=np.uint8)
    if payload is None:
        buf = None
    else:
        buf = payload.ljust(MAC_PAYLOAD_BYTES, b"\x00")
    lib.rt_mac_encode_packet(address & 0x3FF, continuity & 3, buf,
                             1 if scramble else 0, iw & ((1 << 61) - 1),
                             out.ctypes.data)
    return out


# ----------------------------------------------------------------------
# UDT — Unified Date and Time (src/mac.c:515-565)

def build_udt(timestamp: int, gmtoff: int = 0) -> np.ndarray:
    """25-digit UDT sequence for a UTC timestamp.

    The reference uses localtime for the offset and gmtime for the
    fields; golden captures run with TZ=UTC0 so gmtoff=0.
    """
    import datetime
    tm = datetime.datetime.fromtimestamp(timestamp, datetime.timezone.utc)
    i = gmtoff // 1800
    if i < 0:
        i = -i | (1 << 5)
    year = tm.year - 1900
    mon = tm.month - 1
    mjd = int(367.0 * (1900 + year)
              - int(7.0 * (1900 + year + int((1 + mon + 9.0) / 12.0)) / 4.0)
              + int(275.0 * (1 + mon) / 9.0) + tm.day - 678987.0)
    udt = np.zeros(25, dtype=np.uint8)
    udt[0] = mjd // 10000 % 10
    udt[1] = mjd // 1000 % 10
    udt[2] = mjd // 100 % 10
    udt[3] = mjd // 10 % 10
    udt[4] = mjd % 10
    udt[5] = tm.hour // 10 % 10
    udt[6] = tm.hour % 10
    udt[7] = tm.minute // 10 % 10
    udt[8] = tm.minute % 10
    udt[9] = tm.second // 10 % 10
    udt[10] = tm.second % 10
    udt[15] = (i >> 4) & 15
    udt[16] = i & 15
    # chain code 0000101011101100011111001
    for j in range(25):
        udt[j] |= ((0x13E3750 >> j) & 1) << 4
    return udt


# ----------------------------------------------------------------------
# Service Information packets (src/mac.c:664-853)

def _dgh_wrap(pkt: bytearray, x: int):
    """Finish DGS CRC + DGH length shared by DG0/DG3."""
    b = crc16(bytes(pkt[9:9 + pkt[10] + 2]))
    pkt[x] = b & 0xFF
    pkt[x + 1] = (b >> 8) & 0xFF
    x += 1
    pkt[6] = HAMMING[(x & 0xF0) >> 4]
    pkt[7] = HAMMING[x & 0x0F]
    b = crc16(bytes(pkt[1:MAC_PAYLOAD_BYTES - 2]))
    pkt[MAC_PAYLOAD_BYTES - 2] = b & 0xFF
    pkt[MAC_PAYLOAD_BYTES - 1] = (b >> 8) & 0xFF


def si_dg0_packet(audio_address: int) -> bytes:
    """SI DG0 network packet (src/mac.c:664-739)."""
    pkt = bytearray(MAC_PAYLOAD_BYTES)
    pkt[0] = 0xF8
    pkt[1] = HAMMING[0]
    pkt[2] = HAMMING[0]
    pkt[3] = HAMMING[15]
    pkt[4] = HAMMING[0]
    pkt[5] = HAMMING[1]
    pkt[6] = HAMMING[0]
    pkt[7] = HAMMING[0]
    pkt[8] = HAMMING[1]
    pkt[9] = 0x10
    pkt[10] = 11
    x = 11
    pkt[x] = 0x10; x += 1
    pkt[x] = 3 + len(_NWO); x += 1
    pkt[x] = 0x00; x += 1
    pkt[x] = 0x01; x += 1
    pkt[x] = 0x91; x += 1
    pkt[x:x + len(_NWO)] = _NWO
    x += len(_NWO)
    pkt[x] = 0x14; x += 1
    pkt[x] = len(_NWNAME); x += 1
    pkt[x:x + len(_NWNAME)] = _NWNAME
    x += len(_NWNAME)
    pkt[x] = 0x18; x += 1
    pkt[x] = 0x04; x += 1
    pkt[x] = 0x01; x += 1
    pkt[x] = 0x01; x += 1
    b = (3 << 12) | (1 << 10) | audio_address
    pkt[x] = b & 0xFF; x += 1
    pkt[x] = (b >> 8) & 0xFF; x += 1
    pkt[10] = x - pkt[10]
    _dgh_wrap(pkt, x)
    return bytes(pkt)


def si_dg3_packet(audio_address: int, vsam: int, ratio: int,
                  teletext: bool, eurocrypt=None) -> bytes:
    """SI DG3 TV-configuration packet (src/mac.c:741-853).

    `eurocrypt` is None or a dict with keys ecm_addr, packet_type.
    """
    pkt = bytearray(MAC_PAYLOAD_BYTES)
    pkt[0] = 0xF8
    pkt[1] = HAMMING[3]
    pkt[2] = HAMMING[0]
    pkt[3] = HAMMING[15]
    pkt[4] = HAMMING[0]
    pkt[5] = HAMMING[1]
    pkt[6] = HAMMING[0]
    pkt[7] = HAMMING[0]
    pkt[8] = HAMMING[1]
    pkt[9] = 0x90
    pkt[10] = 11
    x = 11
    pkt[x] = 0x40; x += 1
    pkt[x] = 1 + len(_SNAME); x += 1
    pkt[x] = 1; x += 1
    pkt[x:x + len(_SNAME)] = _SNAME
    x += len(_SNAME)
    if eurocrypt is not None:
        EC_S = 0x01
        pkt[x] = 0x80; x += 1
        pkt[x] = 0x0D; x += 1
        pkt[x] = 0x88; x += 1
        pkt[x] = 0x04; x += 1
        b = (1 << 15) | (1 << 10) | eurocrypt["ecm_addr"]
        pkt[x] = b & 0xFF; x += 1
        pkt[x] = (b >> 8) & 0xFF; x += 1
        pt = eurocrypt["packet_type"]
        pkt[x] = 0x40 if pt != EC_S else 0x20; x += 1
        pkt[x] = (pt & 0x30) if pt != EC_S else 0x01; x += 1
    pkt[x] = 0x90; x += 1
    pkt[x] = 1; x += 1
    b = (1 << 5) | (ratio << 4) | vsam
    pkt[x] = b; x += 1
    pkt[x] = 0xA4; x += 1
    pkt[x] = 3; x += 1
    pkt[x] = 0x09; x += 1
    b = 0x0400 | audio_address
    pkt[x] = b & 0xFF; x += 1
    pkt[x] = (b >> 8) & 0xFF; x += 1
    if teletext:
        pkt[x] = 0xF0; x += 1
        pkt[x] = 3; x += 1
        pkt[x] = 0x09; x += 1
        pkt[x] = 0; x += 1
        pkt[x] = 0; x += 1
    pkt[10] = x - pkt[10]
    _dgh_wrap(pkt, x)
    return bytes(pkt)


# ----------------------------------------------------------------------
# Frame-sync line 625 / line 624 content (src/mac.c:1441-1554)

# RDF sequences (src/mac.c:61-78): CID, FL1, LL1, FL2, LL2, FCP, LCP
RDF_D2 = [(0x01, 0, 622, 1023, 1023, 9, 205),
          (0x10, 22, 309, 334, 621, 235, 583),
          (0x11, 22, 309, 334, 621, 589, 1285),
          (0x20, 0, 21, 312, 333, 229, 1292)]

RDF_D = [(0x01, 0, 622, 1023, 1023, 6, 104),
         (0x02, 0, 622, 1023, 1023, 105, 203),
         (0x10, 22, 309, 334, 621, 235, 583),
         (0x11, 22, 309, 334, 621, 589, 1285),
         (0x20, 0, 21, 312, 333, 229, 1292)]


def hsync_word_bits(frame: int, line: int) -> np.ndarray:
    """6-bit line sync word, MSB first (src/mac.c:1363-1373)."""
    hsync = (frame + line) & 1
    if line in (623, 624):
        hsync ^= 1
    return rbits_msb(MAC_LSW if hsync else (~MAC_LSW) & 0x3F, 6)


def line_624_bits(mac_mode_d: bool) -> np.ndarray:
    """Spare bits + clamp marker (src/mac.c:1441-1461)."""
    parts = []
    if not mac_mode_d:
        parts.append(rbits_msb(0xAAAAAAAAAAAAAAAA, 64))
        parts.append(rbits_msb(0x5, 3))
    else:
        parts.append(rbits_msb(0xAAAAAAAAAAAAAAAA, 64))
        parts.append(rbits_msb(0xAAAAAAAAAAAAAAAA, 64))
        parts.append(rbits_msb(0x2AAAAAAAAA, 38))
    parts.append(rbits_msb(MAC_CLAMP, 32))
    return np.concatenate(parts)


class Line625State:
    """Sequential state for frame-sync line 625: the RDF index cycles per
    frame and each entry's LINKS bit toggles on use (src/mac.c:1507-1525)."""

    def __init__(self, mac_mode_d: bool):
        self.rdf_table = RDF_D if mac_mode_d else RDF_D2
        self.rdf = 0
        self.links = [0] * len(self.rdf_table)
        self.mac_mode_d = mac_mode_d

    def content_bits(self, frame: int, udt: np.ndarray, chid: int,
                     vsam: int, aspect_43: int) -> np.ndarray:
        """The 546 interleaved-source bits after CRI+FSW: UDT + SDF +
        5x RDF (src/mac.c:1477-1530)."""
        il = [rbits_msb(int(udt[frame % 25]), 5)]

        df = np.zeros(71, dtype=np.uint8)
        dx = 0
        for val, n in ((chid, 16), (0x00, 8)):
            df[dx:dx + n] = bits_lsb(val, n)
            dx += n
        b = (vsam << 5) | (1 << 4) | (aspect_43 << 3) | (1 << 2) | \
            (1 << 1) | 1
        df[dx:dx + 8] = bits_lsb(b, 8)
        dx += 8
        for val, n in (((frame >> 8) & 0xFFFFF, 20), (1, 1), (1, 1),
                       (3, 2), (0, 1)):
            df[dx:dx + n] = bits_lsb(val, n)
            dx += n
        il.append(bch_encode(df, 71, 57))

        cid, fln1, lln1, fln2, lln2, fcp, lcp = self.rdf_table[self.rdf]
        self.links[self.rdf] ^= 1
        df = np.zeros(94, dtype=np.uint8)
        dx = 0
        for val, n in ((frame & 0xFF, 8), (0, 1), (cid, 8), (fln1, 10),
                       (lln1, 10), (fln2, 10), (lln2, 10), (fcp, 11),
                       (lcp, 11), (self.links[self.rdf], 1)):
            df[dx:dx + n] = bits_lsb(val, n)
            dx += n
        rdf_bits = bch_encode(df, 94, 80)
        self.rdf = (self.rdf + 1) % len(self.rdf_table)
        il.extend([rdf_bits] * 5)
        return np.concatenate(il)

    def content_bits_batch(self, frames: np.ndarray, udt: np.ndarray,
                           chid: int, vsam: int,
                           aspect_43: int) -> np.ndarray:
        """Vectorised content_bits over a block's line-625 frames;
        advances the RDF cycle/LINKS state exactly as F sequential
        content_bits calls would."""
        frames = np.asarray(frames, dtype=np.int64)
        F = len(frames)
        R = len(self.rdf_table)

        udtb = ((udt[frames % 25].astype(np.int64)[:, None]
                 >> (4 - np.arange(5))[None, :]) & 1).astype(np.uint8)

        df71 = np.zeros((F, 71), dtype=np.uint8)
        head = np.zeros(32, dtype=np.uint8)
        head[0:16] = bits_lsb(chid, 16)
        b = (vsam << 5) | (1 << 4) | (aspect_43 << 3) | (1 << 2) | \
            (1 << 1) | 1
        head[24:32] = bits_lsb(b, 8)
        df71[:, :32] = head[None, :]
        df71[:, 32:52] = (((frames >> 8) & 0xFFFFF)[:, None]
                          >> np.arange(20)[None, :]) & 1
        df71[:, 52] = 1
        df71[:, 53] = 1
        df71[:, 54:56] = bits_lsb(3, 2)[None, :]
        sdf = bch_encode_batch(df71, 71, 57)

        idxs = (self.rdf + np.arange(F)) % R
        # occurrence t of entry e reads links post-toggle: init ^ (t+1)
        occ = np.zeros(F, dtype=np.int64)
        counts = np.zeros(R, dtype=np.int64)
        for j in range(F):
            e = int(idxs[j])
            occ[j] = counts[e]
            counts[e] += 1
        links0 = np.asarray(self.links, dtype=np.int64)
        link = (links0[idxs] ^ (occ + 1)) & 1
        tab = np.asarray(self.rdf_table, dtype=np.int64)[idxs]
        df94 = np.zeros((F, 94), dtype=np.uint8)
        df94[:, 0:8] = (frames[:, None] >> np.arange(8)[None, :]) & 1
        x = 9
        for col, nb in ((0, 8), (1, 10), (2, 10), (3, 10), (4, 10),
                        (5, 11), (6, 11)):
            df94[:, x:x + nb] = (tab[:, col][:, None]
                                 >> np.arange(nb)[None, :]) & 1
            x += nb
        df94[:, x] = link
        rdf = bch_encode_batch(df94, 94, 80)

        self.rdf = int((self.rdf + F) % R)
        self.links = list((links0 ^ counts) & 1)
        return np.concatenate([udtb, sdf] + [rdf] * 5, axis=1)
