"""NICAM-728 stereo encoder and DQPSK modulator timing model, on the host
(port of hacktv_tpu/audio/nicam.py).  The frame coder goes through the
native runtime (`rt_nicam_encode_frames`), which raises if it does not
load; `encode_frames(..., native=False)` runs the numpy coder (the plain
version the tests hold the native one against).

Bit-exact re-implementation of the reference encoder
(src/nicam728.c:36-249): J.17 pre-emphasis (fixed int32 taps at 32 kHz),
per-frame scale-factor companding 16->10 bit with parity + signalling
bits, 16-bit interleave, 9-bit PRN whitening, and the DQPSK differential
symbol stream.

The waveform synthesis itself happens on the device (see synth.py); this
module produces, for a span of output samples, the symbol start positions
(exact rational 364 kbaud timing, src/nicam728.c:301-307, 399-407) and the
per-symbol I/Q signs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .. import runtime

NICAM_BIT_RATE = 728000
NICAM_SYMBOL_RATE = NICAM_BIT_RATE // 2
NICAM_AUDIO_RATE = 32000
NICAM_FRAME_BITS = 728
NICAM_FRAME_BYTES = NICAM_FRAME_BITS // 8
NICAM_FRAME_SYMS = NICAM_FRAME_BITS // 2
NICAM_AUDIO_LEN = NICAM_AUDIO_RATE // 1000   # stereo pairs per frame
NICAM_FAW = 0x4E

MODE_STEREO = 0x00
MODE_DUAL_MONO = 0x02
MODE_MONO_DATA = 0x04
MODE_DATA = 0x06

# J.17 pre-emphasis taps, 32 kHz (src/nicam728.c:37-44)
J17_TAPS = np.array([
    -1, 0, -1, -1, -1, -1, -1, -1, -1, -1, -2, -2, -3, -3, -3, -3, -5, -5,
    -6, -7, -9, -10, -13, -14, -18, -21, -27, -32, -42, -51, -69, -86, -120,
    -159, -233, -332, -524, -814, -1402, -2372, -4502, 25590, -4502, -2372,
    -1402, -814, -524, -332, -233, -159, -120, -86, -69, -51, -42, -32, -27,
    -21, -18, -14, -13, -10, -9, -7, -6, -5, -5, -3, -3, -3, -3, -2, -2, -1,
    -1, -1, -1, -1, -1, -1, -1, 0, -1], dtype=np.int64)
J17_NTAPS = len(J17_TAPS)

# DQPSK mappings (src/nicam728.c:47-48)
STEP = np.array([0, 3, 1, 2], dtype=np.int64)
SYMS = np.array([0, 1, 3, 2], dtype=np.int64)

# scale factor table: index -> (factor code, shift) (src/nicam728.c:59-68)
_FACTOR = [0, 1, 2, 4, 3, 5, 6, 7]
_SHIFT = [2, 2, 2, 2, 3, 4, 5, 6]


def prn_sequence() -> np.ndarray:
    """9-bit LFSR whitening bytes for positions 1..90 of the frame
    (src/nicam728.c:96-125)."""
    poly = 0x1FF
    out = np.zeros(NICAM_FRAME_BYTES - 1, dtype=np.uint8)
    for x in range(NICAM_FRAME_BYTES - 1):
        v = 0
        for _ in range(8):
            b = (poly & 1) ^ ((poly >> 4) & 1)
            poly = (poly >> 1) | (b << 8)
            v = ((v << 1) | b) & 0xFF
        out[x] = v
    return out


_PRN = prn_sequence()

# interleave table: bit b of the 704 payload bits maps to position xi
# (src/nicam728.c:220-239): starting xi=0, stepping 16 mod 703.
def _interleave_positions() -> np.ndarray:
    pos = np.zeros(704, dtype=np.int64)
    xi = 0
    for b in range(704):
        pos[b] = xi
        xi += 16
        if xi >= NICAM_FRAME_BITS - 24:
            xi -= NICAM_FRAME_BITS - 24 - 1
    return pos


_ILEAVE = _interleave_positions()


def _wrap16(x: np.ndarray) -> np.ndarray:
    """Wrap to int16 like the reference's int16_t assignment — the J.17
    output (gain > 1) genuinely overflows there (src/nicam728.c:160)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def j17_filter(pcm: np.ndarray) -> np.ndarray:
    """Causal J.17 FIR with int16 wrap-around on output.

    The reference ring walks oldest-to-newest against taps[0..82]
    (src/nicam728.c:147-162): out[n] = sum_j x[n-82+j]*taps[j] >> 15,
    assigned to int16_t (wraps).
    """
    x = np.asarray(pcm, dtype=np.int64)
    # exact: the true accumulator is an integer (|acc| <= sum|taps| *
    # 32767 ~ 1.6e9 < 2^53) and overlap-add FFT convolution's absolute
    # error is far below the 0.5 round() needs to recover it
    try:
        from scipy.signal import oaconvolve as _conv
    except Exception:                            # pragma: no cover
        _conv = np.convolve
    acc = _conv(x.astype(np.float64),
                J17_TAPS[::-1].astype(np.float64))[:len(x)]
    acc = np.round(acc).astype(np.int64)
    return _wrap16(acc >> 15)


def scale_factor_index(block: np.ndarray) -> int:
    """Optimal scale factor for one 32-sample channel block
    (src/nicam728.c:70-94)."""
    b = 1
    for s in block:
        s = ~int(s) if s < 0 else int(s)
        while b < 7 and (s >> (b + 8)):
            b += 1
        if b >= 7:
            break
    return b


def scale_factor_indices(blocks: np.ndarray) -> np.ndarray:
    """Vectorised scale factors: blocks [n, 32] -> [n].

    The reference's incremental max is order-independent: the result is
    min(7, max(1, bitlength(s') - 8)) over the block, s' = ~s for s < 0.
    """
    s = np.where(blocks < 0, ~blocks, blocks).astype(np.int64)
    # bit length of each sample (0 -> 0)
    bl = np.zeros_like(s)
    v = s.copy()
    for shift in (8, 4, 2, 1):
        hit = v >= (1 << shift)
        bl += np.where(hit, shift, 0)
        v = np.where(hit, v >> shift, v)
    bl += (s > 0)
    need = np.clip(bl - 8, 1, 7)
    return np.max(need, axis=-1)


# the coder's tables as the native call takes them
_NATIVE_TABLES = (np.ascontiguousarray(J17_TAPS, dtype=np.int32),
                  np.ascontiguousarray(_SHIFT, dtype=np.int32),
                  np.ascontiguousarray(_FACTOR, dtype=np.int32),
                  np.ascontiguousarray(_ILEAVE, dtype=np.int16),
                  np.ascontiguousarray(_PRN, dtype=np.uint8))


def _encode_frames_native(pairs: np.ndarray, n_frames: int,
                          first_frame_idx: int, mode: int,
                          reserve: int) -> np.ndarray:
    """encode_frames through `rt_nicam_encode_frames` (bit-exact with the
    numpy body, the plain version).  The int16-range PCM is cast to int32
    exactly; the coder wraps J.17 to int16 at each store as the numpy
    body does."""
    if pairs.ndim != 2 or pairs.shape[1] != 2:
        raise ValueError(f"nicam: want PCM pairs [n, 2], got {pairs.shape}")
    lib = runtime.load()
    taps, sh, fa, il, pr = _NATIVE_TABLES
    x = np.ascontiguousarray(
        pairs[:n_frames * NICAM_AUDIO_LEN + J17_NTAPS - 1], dtype=np.int32)
    out = np.empty((n_frames, NICAM_FRAME_BYTES), dtype=np.uint8)
    lib.rt_nicam_encode_frames(
        runtime.ptr(x), n_frames, runtime.ptr(taps), len(taps),
        runtime.ptr(sh), runtime.ptr(fa), runtime.ptr(il), runtime.ptr(pr),
        int(first_frame_idx), int(mode), int(reserve), runtime.ptr(out))
    return out


def encode_frames(pcm_lr: np.ndarray, first_frame_idx: int,
                  mode: int = MODE_STEREO, reserve: int = 1,
                  native: bool = True) -> np.ndarray:
    """Encode consecutive NICAM frames.

    pcm_lr: raw PCM pairs [n_frames*32 + 82, 2] of int16 range, the first
    82 rows being the J.17 filter's history (zeros at the stream start);
    J.17 is applied here.

    Returns frame bytes [n_frames, 91] (uint8).  `native` runs the coder
    of the native runtime, which raises if it does not load;
    `native=False` runs the numpy body below.
    """
    hist = J17_NTAPS - 1
    pairs = np.asarray(pcm_lr, dtype=np.int64)
    n_frames = (len(pairs) - hist) // NICAM_AUDIO_LEN
    if native and n_frames > 0:
        return _encode_frames_native(pairs, n_frames, first_frame_idx,
                                     mode, reserve)

    # J.17 per channel over the continuous stream
    l = j17_filter(pairs[:, 0])[hist:]
    r = j17_filter(pairs[:, 1])[hist:]

    fl = l[:n_frames * 32].reshape(n_frames, 32)
    fr = r[:n_frames * 32].reshape(n_frames, 32)
    bl = scale_factor_indices(fl)          # [n_frames]
    br = scale_factor_indices(fr)

    # interleave L/R then compand (src/nicam728.c:169-182)
    samples = np.empty((n_frames, 64), dtype=np.int64)
    samples[:, 0::2] = fl
    samples[:, 1::2] = fr
    shift = np.empty((n_frames, 64), dtype=np.int64)
    factor = np.empty((n_frames, 64), dtype=np.int64)
    shift_t = np.array(_SHIFT, dtype=np.int64)
    factor_t = np.array(_FACTOR, dtype=np.int64)
    shift[:, 0::2] = shift_t[bl][:, None]
    shift[:, 1::2] = shift_t[br][:, None]
    factor[:, 0::2] = factor_t[bl][:, None]
    factor[:, 1::2] = factor_t[br][:, None]

    v = (samples >> shift) & 0x3FF
    # parity over the 6 MSBs
    p6 = (v >> 4) & 0x3F
    parity = np.zeros_like(p6)
    t = p6
    for sh in (4, 2, 1):
        t = t ^ (t >> sh)
    parity = t & 1
    v |= parity << 10
    # scale-factor signalling on the first 54 samples
    x = np.arange(64)
    sig_bit = (factor >> (2 - (x // 2 % 3))[None, :]) & 1
    v ^= np.where(x[None, :] < 54, sig_bit << 10, 0)

    # header bits
    fnum = first_frame_idx + np.arange(n_frames, dtype=np.int64)
    c0 = ((~fnum) >> 3) & 1
    hdr_b2 = ((c0 << 7) | (((mode >> 2) & 1) << 6) | (((mode >> 1) & 1) << 5)
              | ((mode & 1) << 4) | ((reserve & 1) << 3))
    header = (NICAM_FAW << 16) | (hdr_b2 << 8)
    frame_bits = np.zeros((n_frames, NICAM_FRAME_BITS), dtype=np.uint8)
    frame_bits[:, :24] = ((header[:, None] >> (23 - np.arange(24))[None, :])
                          & 1)

    # payload: sample x, bit b (LSB first) -> interleaved position
    bits = ((v[:, :, None] >> np.arange(11)[None, None, :]) & 1
            ).reshape(n_frames, 704).astype(np.uint8)
    frame_bits[:, 24 + _ILEAVE] = bits

    packed = np.packbits(frame_bits, axis=1)
    packed[:, 1:] ^= _PRN[None, :]
    return packed


@dataclass
class SymbolTiming:
    """Exact symbol timing at `sample_rate` (src/nicam728.c:301-307):
    symbol k (0-based) starts at output sample S(k) = sps*k - floor(dsl*k
    / decimation)."""
    sps: int
    dsl: int
    decimation: int

    @classmethod
    def create(cls, sample_rate: int,
               symbol_rate: int = NICAM_SYMBOL_RATE) -> "SymbolTiming":
        n = math.gcd(sample_rate, symbol_rate)
        decimation = symbol_rate // n
        sps = (sample_rate + symbol_rate - 1) // symbol_rate
        dsl = (sps * decimation) % (sample_rate // n)
        return cls(sps=sps, dsl=dsl, decimation=decimation)

    def start(self, k):
        k = np.asarray(k, dtype=np.int64)
        return self.sps * k - (self.dsl * k) // self.decimation

    def sym_range(self, n0: int, n1: int, ntaps: int) -> tuple[int, int]:
        """Symbols whose pulse [S(k), S(k)+ntaps) intersects [n0, n1)."""
        # S(k) ~ k * rate; invert conservatively
        avg = self.sps - self.dsl / self.decimation
        k0 = max(0, int((n0 - ntaps) / avg) - 2)
        while self.start(k0 + 1) + ntaps <= n0:
            k0 += 1
        k1 = max(k0, int(n1 / avg) + 2)
        while self.start(k1 - 1) >= n1 and k1 > k0:
            k1 -= 1
        return k0, k1


def frame_symbols(frames: np.ndarray) -> np.ndarray:
    """2-bit symbol pairs from frame bytes, USB first
    (src/nicam728.c:381-384): bit pairs (7,6), (5,4), ... of each byte."""
    bits = np.unpackbits(frames.reshape(-1, NICAM_FRAME_BYTES), axis=1)
    pairs = bits.reshape(frames.shape[0], NICAM_FRAME_SYMS, 2)
    return (pairs[..., 0] << 1 | pairs[..., 1]).astype(np.int64)


def differential_encode(pairs: np.ndarray, dsym_in: int) -> tuple[np.ndarray, int]:
    """dsym_k = (dsym_{k-1} + STEP[pair_k]) mod 4; returns per-symbol
    (I sign, Q sign) from SYMS and the final state."""
    steps = STEP.astype(np.int32)[pairs]
    dsym = (dsym_in + np.cumsum(steps, dtype=np.int64)) & 3
    sym = SYMS[dsym]
    out = np.empty((len(sym), 2), dtype=np.float32)
    out[:, 0] = np.where(sym & 1, 1.0, -1.0)
    out[:, 1] = np.where(sym & 2, 1.0, -1.0)
    return out, int(dsym[-1]) if len(dsym) else dsym_in


def mod_taps(sample_rate: int, beta: float, level: float,
             symbol_rate: int = NICAM_SYMBOL_RATE) -> np.ndarray:
    """RRC x Hamming pulse-shaping taps, int16-quantised
    (src/nicam728.c:257-288; identical construction for DANCE,
    src/dance.c:359-390)."""
    from ..ops.shapes import rrc
    sps = sample_rate / float(symbol_rate)
    ntaps = (int(sps * 5) + 1) | 1
    n = ntaps // 2
    x = np.arange(-n, n + 1, dtype=np.float64)
    t = x / sps
    hamming = np.where(np.abs(x / n) <= 1,
                       0.54 - 0.46 * np.cos(np.pi * (1.0 + x / n)), 0.0)
    r = rrc(t, beta, 1.0) * hamming
    r = r * (np.sqrt(0.5) * 32767 * level)
    return np.round(r).astype(np.int64)
