"""RF chain operations after the audio carriers: FM video and the complex
frequency offset.

Port of hacktv_tpu/rf/ops.py, batched replacements for the reference's
per-sample modulator processes:

  - FM video (src/video.c:2299-2335, 3452-3464): the phase integral of the
    int16 composite, exact: a line's sample sums are exact int32, the
    cross-line sum runs modulo the phase modulus, and the carry across
    blocks is one integer (the device closed form; the encoder runs the
    reference's serial recurrence on the host where it can,
    runtime.FmCarrierExact);
  - the complex frequency offset (src/video.c:3482-3515), with the
    reference's truncated int32 intro phasor emulated exactly;
  - swap-IQ (src/video.c:3466-3480) is an exchange in the encoder.

Quantisation mirrors the reference's (phase>>16)*level>>15 chains.  The
host statics and the per-line rotation state are numpy, as in the JAX
package; the block programs run on the tensors' device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from ..audio.synth import _sincosf_glibc, fma32


@dataclass
class FMVideoStatics:
    kd: float            # rad per unit sample: 2*pi*deviation/(fs*32767)
    level_int: int       # round(32767 * fm_level * level)
    lines_per_frame: int
    num: int = 0         # deviation/(fs*32767) as a reduced fraction:
    den: int = 1         # phase/2pi advances by num/den per unit sample


def make_fm_video_statics(deviation: float, level: float, sample_rate: int,
                          lines_per_frame: int) -> FMVideoStatics:
    fr = Fraction(deviation).limit_denominator(1 << 20) \
        / (sample_rate * 32767)
    if not (0 < fr.denominator < 2**31):
        raise ValueError("FM deviation/sample-rate ratio too irrational "
                         "for exact phase accumulation")
    return FMVideoStatics(
        kd=2.0 * np.pi * deviation / (sample_rate * 32767.0),
        level_int=int(round(32767 * level)),
        lines_per_frame=lines_per_frame,
        num=fr.numerator, den=fr.denominator)


def fm_energy_dispersal_frame(ed: float, width: int,
                              lines: int) -> np.ndarray | None:
    """One frame of the FM energy-dispersal triangle, int16 [lines, width].

    The reference (src/video.c:2245-2257) runs a Bresenham counter at
    level*4*frequency/sample_rate per sample with the frequency locked to
    sample_rate/(width*lines) (src/video.c:4573-4581), and offsets each
    composite sample by abs(counter - level*2) - level before the FM LUT
    (src/video.c:2301-2318).  counter(n) = floor(n*4L/P) mod 4L with
    P = width*lines, so the waveform is exactly one frame long."""
    level = int(round(32767 * ed))
    if level == 0:
        return None
    P = width * lines
    n = np.arange(P, dtype=np.int64)
    c = (n * (4 * level)) // P % (4 * level)
    tri = np.abs(c - 2 * level) - level
    return tri.astype(np.int16).reshape(lines, width)


def fm_video_modulate(st: FMVideoStatics, x: torch.Tensor, r0: torch.Tensor,
                      tri: torch.Tensor | None = None):
    """FM-modulate the baseband block x (f32 [nlines, W], the int16-scaled
    composite with the audio subcarriers).  r0: int64 scalar carry, the
    sum of all earlier blocks' quantised samples mod `den`.  `tri`: the
    energy-dispersal triangle tiled to the block (int32), or None.

    The phase integral of the quantised composite is exact: a line's
    running sums are int32 (|sum| < W * 2^15), the line totals' prefix
    sums are one int64 cumsum taken mod den (den < 2^31, so tens of
    thousands of lines stay far below 2^63), and the base angle of each
    line is 2*pi * ((num * S) mod den) / den with one int64 product
    (both factors below 2^31).  Within a line, kd * running sum in f32 as
    the JAX package has it (the error resets at every line start).

    Bit for bit the JAX encoder on its CPU backend: cos/sin are glibc's,
    the phase reaching thousands of radians (glibc's large-argument
    reduction, `_sincosf_glibc(large=True)`); of base + kd * sum, XLA's
    CPU compiler fuses the product (fma32).

    Returns (out_i, out_q, the next block's r0 as a device scalar)."""
    B, W = x.shape
    den = st.den
    i64 = torch.int64

    # the reference modulates the int16-quantised composite
    # (src/video.c:3452-3464); quantise first
    xq = torch.round(torch.clamp(x, -32768, 32767)).to(torch.int32)
    if tri is not None:
        # energy dispersal: the reference's `sample += tri` is an int16
        # add that wraps (src/video.c:2303)
        xq = ((xq + tri + 0x8000) & 0xFFFF) - 0x8000
    col_cum = torch.cumsum(xq, dim=1, dtype=torch.int32)    # inclusive
    Tm = col_cum[:, -1].to(i64) % den                       # line totals
    s_incl = (torch.cumsum(Tm, 0) + r0.to(i64) % den) % den
    s_excl = (s_incl - Tm) % den
    acc = (s_excl * (st.num % den)) % den
    base = acc.to(torch.float32) * float(np.float32(2.0 * np.pi / den))

    # within-line deviation phase (the sample's own step applies before
    # output, src/video.c:2320)
    phi = fma32(col_cum.to(torch.float32), float(np.float32(st.kd)),
                base[:, None].expand(B, W))
    cq, ci = _sincosf_glibc(phi, large=True)
    lvl = float(st.level_int)
    inv = 1.0 / 32768.0
    out_i = torch.floor(torch.clamp(torch.floor(ci * 32768.0), -32768, 32767)
                        * lvl * inv)
    out_q = torch.floor(torch.clamp(torch.floor(cq * 32768.0), -32768, 32767)
                        * lvl * inv)
    return out_i, out_q, s_incl[-1]


@dataclass
class OffsetStatics:
    cos_x: torch.Tensor      # f32 [W] rotation table at col+1 (the phase
    sin_x: torch.Tensor      # advances before the first output sample)
    # the reference's first 32767 samples rotate by a tiny int32 phasor
    # whose b = phase >> 16 factors are in {-2..0}; emulated exactly per
    # sample and laid out as whole lines
    intro_bi: torch.Tensor = None   # int8 [intro_rows, W]
    intro_bq: torch.Tensor = None


_INT32_MAX = 2**31 - 1
_INTRO = 32767           # samples before the first phase renormalisation
_offset_const_cache: dict = {}


def _offset_delta(offset_hz: int, sample_rate: int):
    """The reference's quantised per-sample phasor (lround of cos/sin of
    the step times INT32_MAX)."""
    d = 2.0 * math.pi / sample_rate * offset_hz
    di = int(math.floor(math.cos(d) * _INT32_MAX + 0.5))
    dq_ = math.sin(d) * _INT32_MAX
    dq = int(math.floor(dq_ + 0.5)) if dq_ >= 0 else -int(
        math.floor(-dq_ + 0.5))
    return di, dq


def _offset_consts(offset_hz: int, sample_rate: int):
    """The reference's offset rotator is an int32 phase recurrence
    (src/video.c:3482-3515) whose accumulator starts at magnitude
    INT16_MAX, not INT32_MAX (src/video.c:4596-4598), so `phase >> 16` is
    in {-1, 0} and the rotated output is about zero for the first 32767
    samples, until the amplitude correction renormalises the phasor to
    full scale.  From then on the recurrence is a clean rotation by the
    quantised step angle.  Returns (datan, ra0): the per-sample angle step
    atan2(dq, di) and the exact phase angle at the first renormalisation,
    from the 32767 truncated cint32 multiplies in exact integers."""
    key = (int(offset_hz), int(sample_rate))
    hit = _offset_const_cache.get(key)
    if hit is not None:
        return hit
    di, dq = _offset_delta(offset_hz, sample_rate)
    datan = math.atan2(dq, di)
    pi_, pq = 32767, 0
    for _ in range(_INTRO):
        pi_, pq = ((pi_ * di - pq * dq) >> 31), ((pi_ * dq + pq * di) >> 31)
    ra0 = math.atan2(pq, pi_)
    _offset_const_cache[key] = (datan, ra0)
    return datan, ra0


def make_offset_statics(offset_hz: int, sample_rate: int, width: int,
                        device="cuda") -> OffsetStatics:
    datan, _ = _offset_consts(offset_hz, sample_rate)
    x = np.arange(1, width + 1, dtype=np.float64)
    ang = np.mod(x * datan, 2.0 * np.pi)
    # the exact intro: the reference's truncated-cint32 recurrence over the
    # pre-renormalisation span; sample n uses the phasor after n + 1
    # multiplies (sample 32767 is the first renormalised one)
    di, dq = _offset_delta(offset_hz, sample_rate)
    rows = -(-_INTRO // width)
    bi = np.zeros(rows * width, dtype=np.int8)
    bq = np.zeros(rows * width, dtype=np.int8)
    pi_, pq = 32767, 0
    for n in range(_INTRO):
        pi_, pq = ((pi_ * di - pq * dq) >> 31), ((pi_ * dq + pq * di) >> 31)
        bi[n] = pi_ >> 16
        bq[n] = pq >> 16
    t = lambda a: torch.as_tensor(a, device=device)
    return OffsetStatics(
        cos_x=t(np.cos(ang).astype(np.float32)),
        sin_x=t(np.sin(ang).astype(np.float32)),
        intro_bi=t(bi.reshape(rows, width)),
        intro_bq=t(bq.reshape(rows, width)))


def offset_rotation(offset_hz: int, sample_rate: int, k0: int, width: int,
                    nlines: int):
    """Per-line rotation state (host, f64-exact): the base angle's cos/sin
    and the per-line count of leading output samples before the
    reference's first phase renormalisation (absolute sample < 32767)."""
    datan, ra0 = _offset_consts(offset_hz, sample_rate)
    n_line = np.maximum(np.arange(k0, k0 + nlines, dtype=np.int64), 0) * width
    # sample n (>= 32767) is rotated by ra0 + (n - 32766) * datan; the
    # column table contributes (col+1) * datan, so the line base is
    # ra0 + (n_line - 32767) * datan
    ang = np.mod(ra0 + (n_line.astype(np.float64) - _INTRO) * datan,
                 2.0 * np.pi)
    nz = np.clip(_INTRO - n_line, 0, width).astype(np.int32)
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
            nz)


def offset_rotate(st: OffsetStatics, out_i: torch.Tensor, out_q: torch.Tensor,
                  c0: torch.Tensor, s0: torch.Tensor, nz: torch.Tensor,
                  k_rows: torch.Tensor | None = None):
    """Complex rotation by the offset carrier with the reference's
    quantisation: b = phase >> 16 (about cos * 32768), (a*b) >> 15.
    Samples before the reference's first phase renormalisation (per-line
    leading count `nz`) use the emulated truncated-cint32 intro phasor at
    stream lines `k_rows`; without `k_rows` they are zeroed.

    Bit for bit the JAX encoder on its CPU backend, as its compiled step
    for Encoder("i", 20 MS/s, offset=-2.25 MHz) has it: of c0*cos_x -
    s0*sin_x, s0*cos_x + c0*sin_x and out_i*bi - out_q*bq the first
    product is fused (fma32) and the second rounded; of out_i*bq +
    out_q*bi the second is fused."""
    W = out_i.shape[-1]
    c0, s0 = c0[:, None], s0[:, None]
    cos_x, sin_x = st.cos_x[None, :], st.sin_x[None, :]
    cc = fma32(c0, cos_x, -(s0 * sin_x))
    cs = fma32(s0, cos_x, c0 * sin_x)
    bi = torch.clamp(torch.floor(cc * 32768.0), -32768, 32767)
    bq = torch.clamp(torch.floor(cs * 32768.0), -32768, 32767)
    cols = torch.arange(W, dtype=torch.int32, device=out_i.device)[None, :]
    keep = None
    if k_rows is not None and st.intro_bi is not None:
        rows = st.intro_bi.shape[0]
        ir = torch.clamp(k_rows, 0, rows - 1).long()
        in_intro = (k_rows >= 0) & (k_rows < rows)
        sel = in_intro[:, None] & (cols < nz[:, None])
        bi = torch.where(sel, st.intro_bi[ir].to(bi.dtype), bi)
        bq = torch.where(sel, st.intro_bq[ir].to(bq.dtype), bq)
    else:
        keep = cols >= nz[:, None]
    inv = 1.0 / 32768.0
    ri = torch.floor(fma32(out_i, bi, -(out_q * bq)) * inv)
    rq = torch.floor(fma32(out_q, bi, out_i * bq) * inv)
    if keep is not None:
        return torch.where(keep, ri, 0.0), torch.where(keep, rq, 0.0)
    return ri, rq
