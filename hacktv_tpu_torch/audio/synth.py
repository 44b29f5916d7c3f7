"""Audio subcarrier synthesis on the device: the FM carrier and NICAM.

Port of the FM and NICAM parts of hacktv_tpu/audio/synth.py, batched
replacements for the reference's per-sample modulators
(src/video.c:3392-3443):

  - FM carrier: phase = carrier term (static per-column angle table +
    per-line rotation) + deviation term (piecewise-linear within the
    zero-order-hold segments); cos/sin per sample, or at every fourth
    sample with a rotation chain between (line widths that are a multiple
    of 128).  `fm_prepare` assembles the per-line segment arguments on
    the device from the compact per-block upload; its window offsets are
    host ints, so the windows are plain slices.
  - NICAM DQPSK (src/nicam728.c:342-411): the 364 kbaud symbol grid
    repeats against the line grid with a small period P (125 lines for
    16 MS/s PAL), so the pulse shapes of the symbols overlapping each line
    form a static [P, NSLOT, W] tap tensor and synthesis is one batched
    matmul over per-line symbol amplitudes, then the reference's int32
    carrier mix.

All quantisation follows the reference's integer arithmetic: carrier
values round to the int16 grid, products floor-divide by 2^15/2^16.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import transfer


@dataclass
class FMStatics:
    level_int: int
    kd: float
    cos_x: torch.Tensor    # f32 [W] carrier angle table at col+1
    sin_x: torch.Tensor
    nseg: int
    eps: float = 0.0       # deterministic tie-break phase lag
    # cos/sin at every sample even where the rotation chain applies
    # (hacktv_tpu's fm_direct_trig)
    direct: bool = False


def make_fm_statics(num: int, den: int, level_int: int, kd: float,
                    width: int, nseg: int, eps: float = 0.0,
                    device="cuda") -> FMStatics:
    # theta_c(n) = 2*pi*num*(n+1)/den; per-column part for n = line*W + col
    x = np.arange(1, width + 1, dtype=np.int64)
    ang = 2.0 * np.pi * ((x * num) % den) / den
    return FMStatics(
        level_int=level_int, kd=kd,
        cos_x=torch.as_tensor(np.cos(ang).astype(np.float32), device=device),
        sin_x=torch.as_tensor(np.sin(ang).astype(np.float32), device=device),
        nseg=nseg, eps=eps)


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add a*b + c (b a tensor or an f32 value as a
    Python float), for the steps XLA's CPU compiler contracts.  The
    product of two f32 values is exact in f64, so the f64 sum (fused or
    not) is rounded once and then to f32.  That double rounding differs
    from one true rounding only when the f64 sum lands exactly on an f32
    rounding midpoint, about 2^-29 of inputs.  The CPU and the card
    compute the same bits (an f32 torch.addcmul contracts differently on
    each)."""
    if isinstance(b, float):
        # a scalar stays on the host: a device copy of it would wait for
        # the card
        return torch.add(c.double(), a.double(), alpha=b).float()
    return torch.addcmul(c.double(), a.double(), b.double()).float()


# glibc's single-precision sine and cosine (2.36, sysdeps/ieee754/flt-32:
# s_sinf.c, s_cosf.c, sincosf.h, sincosf_data.c), which is what the JAX
# reference's CPU backend calls for f32 cos/sin.  The constants are
# __sincosf_table[0] as the installed x86-64 libm.so.6 holds it, and the
# arithmetic is that of its FMA variant (__sinf_fma/__cosf_fma, the one
# glibc selects on CPUs with FMA and AVX2), read from its disassembly:
#   n = ((int32)(x * 2/pi * 2^24) + 2^23) >> 24,   r = fma(-n, pi/2, x)
#   sin: fma(r^5, fma(r^2, S3, S2), fma(r^3, S1, r))
#   cos: fma(r^6, fma(r^2, C4, C3), fma(r^4, C2, fma(r^2, C1, C0)))
# in f64, the quadrant n & 3 picking the polynomial and the sign, and one
# rounding to f32.  For |x| < 0.75 glibc skips the reduction, which is
# the same arithmetic with n = 0; below 2^-12 it returns x and 1, which
# the polynomials round to as well.
_SC_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")     # 2/pi * 2^24
_SC_HPI = float.fromhex("0x1.921fb54442d18p+0")          # pi/2
# pi/2 split into 25 + 28 significant bits: for |x| < 120 (|n| <= 76)
# n*HI and n*LO are exact, and so is x - n*HI (both multiples of 2^-24,
# the difference below 1), so (x - n*HI) - n*LO rounds once, as the
# fused reduction does
_SC_HPI_HI = float.fromhex("0x1.921fb5p+0")
_SC_HPI_LO = _SC_HPI - _SC_HPI_HI
_SC_C = tuple(float.fromhex(h) for h in (
    "0x1p+0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SC_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
SINCOSF_MAX = 120.0     # glibc's fast-reduction range
# glibc's reduce_large (sincosf.h) for |x| >= 120: 4/pi to 192 bits, eight
# new bits per entry (__inv_pio4, sincosf_data.c), and pi/2 * 2^-62
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
             0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
             0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
             0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
             0x95993c43, 0x993c4390, 0x3c439041)
_SC_PI63 = float.fromhex("0x1.921fb54442d18p-62")
_M32 = 0xFFFFFFFF


_INV_PIO4_DEV = {}


def _inv_pio4(device) -> torch.Tensor:
    """_INV_PIO4 as an int64 tensor on `device`, made once: a copy from
    host memory in the step would wait for the card's queue."""
    key = str(device)
    if key not in _INV_PIO4_DEV:
        _INV_PIO4_DEV[key] = torch.tensor(_INV_PIO4, dtype=torch.int64,
                                          device=device)
    return _INV_PIO4_DEV[key]


def _reduce_large(x: torch.Tensor):
    """glibc's reduce_large at every element of an f32 tensor: (n, r) with
    x = n*pi/2 + r, in the integer arithmetic glibc uses.  The mantissa
    (24 bits shifted by up to 7) times three 32-bit words of 4/pi gives
    the 2.62 fixed-point fraction of |x| * 4/pi mod 8; its 64-bit sum runs
    here as two 32-bit halves in int64, where no product or sum
    overflows.  The signed remainder converts to f64 once and scales by
    pi/2 * 2^-62, as glibc does.  For x < 0 the pair is that of |x|
    negated, which is how glibc's sign handling comes out."""
    xi = x.view(torch.int32).to(torch.int64) & _M32
    tab = _inv_pio4(x.device)
    j = (xi >> 26) & 15
    m = ((xi & 0xFFFFFF) | 0x800000) << ((xi >> 23) & 7)    # < 2^31
    res0 = (m * tab[j]) & _M32            # a uint32 product in C
    res1 = m * tab[j + 4]                 # < 2^63
    res2 = m * tab[j + 8]
    # res0 = (res2 >> 32) | (res0 << 32); res0 += res1  (mod 2^64)
    lo = (res2 >> 32) + (res1 & _M32)
    hi = (res0 + (res1 >> 32) + (lo >> 32)) & _M32
    lo &= _M32
    n = ((hi + (1 << 29)) & _M32) >> 30   # (res0 + 2^61) >> 62
    hi = (hi - (n << 30)) & _M32          # res0 -= n << 62
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)
    r = (hi * (1 << 32) + lo).double() * _SC_PI63
    neg = x < 0
    return (torch.where(neg, -n, n).to(torch.int32),
            torch.where(neg, -r, r))


def _sincosf_glibc(x: torch.Tensor, large: bool = False):
    """(sinf(x), cosf(x)) of an f32 tensor, bit for bit as glibc computes
    them (see above), on any device.  The polynomial steps are not fused
    here; that moves the f32 result about 2^-28 of the time.  Without
    `large`, only glibc's paths for |x| < 120 run: a larger or non-finite
    input fails a device-side assertion (raises on the CPU) instead of
    returning a wrong value.  With `large`, inputs of |x| >= 120 take
    glibc's reduce_large (`_reduce_large`), at the cost of a dozen int64
    passes over the tensor; a non-finite input fails the assertion."""
    if x.numel():
        if large:
            torch._assert_async(torch.isfinite(x).all(),
                                "_sincosf_glibc: input not finite")
        else:
            torch._assert_async(x.abs().amax() < SINCOSF_MAX,
                                "_sincosf_glibc: |x| >= 120 or not finite")
    xd = x.double()
    if large:
        # the fast reduction's int32 quadrant would overflow there
        big = x.abs() >= SINCOSF_MAX
        xd = torch.where(big, 0.0, xd)
    n = ((xd * _SC_HPI_INV).to(torch.int32) + 0x800000) >> 24
    nd = n.double()
    r = (xd - nd * _SC_HPI_HI).sub_(nd * _SC_HPI_LO)
    del xd, nd
    if large:
        n_l, r_l = _reduce_large(x)
        n = torch.where(big, n_l, n)
        r = torch.where(big, r_l, r)
        del big, n_l, r_l
    r2 = r * r
    r3 = r2 * r
    s = (r3 * _SC_S[0]).add_(r)
    s = (r3.mul_(r2)).mul_((r2 * _SC_S[2]).add_(_SC_S[1])).add_(s)
    r4 = r2 * r2
    c = (r4 * _SC_C[2]).add_((r2 * _SC_C[1]).add_(_SC_C[0]))
    c = (r4.mul_(r2)).mul_(r2.mul_(_SC_C[4]).add_(_SC_C[3])).add_(c)
    s, c = s.float(), c.float()
    # quadrant n & 3: sin = (S, C, -S, -C), cos = (C, -S, -C, S)
    odd = (n & 1).bool()
    sin = torch.where(odd, c, s)
    cos = torch.where(odd, s, c)
    sin = torch.where((n & 2).bool(), -sin, sin)
    cos = torch.where(((n + 1) & 2).bool(), -cos, cos)
    return sin, cos


def tile_rows(tab: torch.Tensor, B: int) -> torch.Tensor:
    """Tile a per-period [P, W] table to B lines (a view when P == 1)."""
    P = tab.shape[0]
    if P == 1:
        return tab.expand(B, -1)
    if P >= B:
        return tab[:B]
    return tab.repeat(-(-B // P), 1)[:B]


def _telescope(seg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The reference's telescoped f32 step function
    seg_0 + sum_j [col >= c_j] (seg_j - seg_j-1), summed left to right, at
    every column of k ([B, C] segment index of each column).  The segment
    starts c_j increase along j, so a column's sum stops at its own
    segment: the f32 prefix sums over the [B, NSEG] table, picked by k, are
    the same bits."""
    d = seg[:, 1:] - seg[:, :-1]
    acc = [seg[:, 0]]
    for j in range(seg.shape[1] - 1):
        acc.append(acc[-1] + d[:, j])
    return torch.gather(torch.stack(acc, 1), 1, k)


def _rotation_chain(segA, segB, k, colsf, K: int = 4):
    """(sin, cos) of the phase by hacktv_tpu's piecewise rotation (fm_add's
    chain branch): the phase is affine inside each hold segment, so
    cos/sin are evaluated at every K-th column only, and the K - 1
    columns after it follow by angle addition with the segment's step
    rotation (cos/sin of its slope, telescoped like the phase).  W must
    be a multiple of K.  glibc's sincosf then runs at W/K columns and
    over the [B, NSEG] step table, not at every sample.

    Mirrors XLA's CPU contraction in the JAX encoder's step: the phase at
    column K*m is fma(Bc, col, A), and of c*cb - s*sb and s*cb + c*sb
    the second product is rounded and the first fused into the add or
    subtract."""
    B, W = k.shape
    k0 = k[:, ::K].contiguous()
    s_cur, c_cur = _sincosf_glibc(fma32(_telescope(segB, k0),
                                        colsf[:, ::K],
                                        _telescope(segA, k0)))
    segSB, segCB = _sincosf_glibc(segB)
    CB = _telescope(segCB, k)
    SB = _telescope(segSB, k)
    pc, ps = [c_cur], [s_cur]
    for t in range(1, K):
        cb, sb = CB[:, t::K], SB[:, t::K]
        c_cur, s_cur = (fma32(c_cur, cb, -(s_cur * sb)),
                        fma32(s_cur, cb, c_cur * sb))
        pc.append(c_cur)
        ps.append(s_cur)
    return (torch.stack(ps, 2).reshape(B, W),
            torch.stack(pc, 2).reshape(B, W))


def fm_add(st: FMStatics, out_i: torch.Tensor, out_q: torch.Tensor,
           seg_val: torch.Tensor,   # f32 [B, NSEG]
           seg_cnt: torch.Tensor,   # f32 [B, NSEG] phase counts in [0, M),
                                    # or phase bases in rad (unit None)
           seg_col: torch.Tensor,   # i32 [B, NSEG]
           ctab: torch.Tensor,      # f32 [P] carrier cos per line, period P
           stab: torch.Tensor,      # f32 [P]
           unit: float | None,      # f32(2*pi/M): radians per count
           phi_extra: torch.Tensor | None = None,   # f32 [B, W] extra phase
           a2: bool = False,
           ):
    """Add one FM carrier to the (I, Q) block [B, W].

    The per-column phase is piecewise affine over the hold segments
    (the reference's telescoped f32 sums, looked up per segment).  Where
    W is a multiple of 128, `st.direct` is off and there is no extra
    phase, cos/sin come from the rotation chain (`_rotation_chain`), else
    one cos/sin per sample.  `phi_extra` (the A2 pilot, a2_pilot_phase)
    is added to the phase at every sample.  Line b's carrier rotation is
    ctab/stab[b % P].  With `unit` None, `seg_cnt` holds the phase base of
    each segment in radians (the host-assembled AudioChain.fm_block).
    (The JAX package also has a magnitude-decay term that its encoder
    never sets.)

    Bit for bit the JAX encoder on its CPU backend, where fm_prepare,
    fm_add and the rest of the block run in one compiled step: cos/sin
    are glibc's (`_sincosf_glibc`), and each product that XLA's CPU
    compiler fuses into the following add or subtract is fused here, in
    f64 where the f32 product is exact (see `fma32`); every other product
    is rounded on its own.  Which products fuse depends on what is
    compiled together, read from the object code of the JAX encoder's
    step for each case; a JAX fm_add jitted on its own fuses differently
    again.  `a2` marks a step with the A2 second carrier, whose two
    carriers take their held values from the host.  The cases, as the
    object code of Encoder("g"/"i", 16 MS/s) and Encoder("m", 13.5 and
    13.5135 MS/s) with and without A2 has them:

      - segment phase A = cnt*unit + (kd*v)*(1 - c): cnt*unit fused,
        except for the rotation chain of an A2 step, where segment 0
        fuses cnt*unit and every later segment (kd*v)*(1 - c); with host
        phase bases, base + (kd*v)*(1 - c) fuses its product;
      - direct phase A + Bc*col: fused, except for the A2 second carrier
        on lines whose width is a multiple of 128, where Bc*col is
        rounded;
      - carrier rotation cc = c0*cos_x - s0*sin_x, cs = s0*cos_x +
        c0*sin_x: the first product fused, except cc beside the rotation
        chain and both for that A2 second carrier, where the products are
        rounded."""
    B, W = out_i.shape
    f32 = torch.float32
    colsf = torch.arange(W, dtype=f32, device=out_i.device)[None, :]
    kd = float(np.float32(st.kd))

    # affine pieces: phi_j(col) = A_j + B_j*col with
    # A_j = base_j + kd*v_j*(1 - c_j), B_j = kd*v_j, base_j = cnt_j*unit
    # (kd*v and 1 - c rounded; which product fuses: see the docstring)
    chain = not st.direct and W % 128 == 0 and phi_extra is None
    segB = kd * seg_val
    one_c = 1.0 - seg_col.to(f32)
    if unit is None:
        segA = fma32(segB, one_c, seg_cnt)
    elif chain and a2:
        segA = fma32(segB, one_c, seg_cnt * unit)
        segA[:, 0] = fma32(seg_cnt[:, 0], unit, segB[:, 0] * one_c[:, 0])
    else:
        segA = fma32(seg_cnt, unit, segB * one_c)

    cols = torch.arange(W, dtype=torch.int32, device=out_i.device)
    k = torch.searchsorted(seg_col[:, 1:].contiguous(),
                           cols.expand(B, W).contiguous(), right=True)
    # the A2 second carrier at a width of a multiple of 128
    a2_wide = a2 and phi_extra is not None and W % 128 == 0
    if chain:
        sphi, cphi = _rotation_chain(segA, segB, k, colsf)
    else:
        if a2_wide:
            phi = _telescope(segA, k) + _telescope(segB, k) * colsf
        else:
            phi = fma32(_telescope(segB, k), colsf, _telescope(segA, k))
        if phi_extra is not None:
            phi = phi + phi_extra
        sphi, cphi = _sincosf_glibc(phi)
    del k

    # carrier angle theta_c = rot(line) + table(col), over one period of
    # lines and then tiled (the cases in the docstring), then cos/sin of
    # theta_c + phi: of a*b -+ c*d, c*d is rounded and a*b fused
    c0, s0 = ctab[:, None], stab[:, None]
    cos_x, sin_x = st.cos_x[None, :], st.sin_x[None, :]
    if a2_wide:
        cc = c0 * cos_x - s0 * sin_x
        cs = s0 * cos_x + c0 * sin_x
    else:
        cc = (c0 * cos_x - s0 * sin_x if chain
              else fma32(c0, cos_x, -(s0 * sin_x)))
        cs = fma32(s0, cos_x, c0 * sin_x)

    # cos/sin(theta_c + phi); cc*cphi and cs*cphi are exact in f64
    cphi = cphi.double()
    ci = (tile_rows(cc.double(), B) * cphi).sub_(
        (tile_rows(cs, B) * sphi).double()).float()
    cq = (tile_rows(cs.double(), B) * cphi).add_(
        (tile_rows(cc, B) * sphi).double()).float()
    del cphi, sphi
    # tie-break rotation matching the reference's int-iteration phase lag,
    # fused as ci - e*cq and cq + e*ci from the old ci and cq (e*x is
    # exact in f64)
    if st.eps:
        e = float(np.float32(st.eps))
        ci, cq = ci.double(), cq.double()
        ci, cq = (torch.add(ci, cq, alpha=-e).float(),
                  torch.add(cq, ci, alpha=e).float())

    # reference: ((phase.i >> 16) * level) >> 15 — two truncating shifts.
    # phase.i>>16 yields at most 32767 (int32 phase magnitude 2^31-1);
    # floor(cos*32768) hits 32768 at the exact peaks, so clamp
    lvl = float(st.level_int)
    inv = 1.0 / 32768.0
    add_i = torch.floor(
        torch.clamp(torch.floor(ci * 32768.0), -32768, 32767) * lvl * inv)
    add_q = torch.floor(
        torch.clamp(torch.floor(cq * 32768.0), -32768, 32767) * lvl * inv)
    return out_i + add_i, out_q + add_q


@dataclass
class A2Statics:
    """Static column tables for the A2 pilot chain (the ~54.7 kHz pilot
    AM-modulated by the 117.5/149.9 Hz mode tone, src/video.c:3404-3421)."""
    cos1_x: torch.Tensor
    sin1_x: torch.Tensor
    cos2_x: torch.Tensor
    sin2_x: torch.Tensor
    level2: int
    kd: float


def make_a2_statics(pilot: dict, kd: float, width: int,
                    device="cuda") -> A2Statics:
    x = np.arange(1, width + 1, dtype=np.int64)
    a1 = 2.0 * np.pi * ((x * pilot["num1"]) % pilot["den1"]) / pilot["den1"]
    a2 = 2.0 * np.pi * ((x * pilot["num2"]) % pilot["den2"]) / pilot["den2"]
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return A2Statics(cos1_x=t(np.cos(a1)), sin1_x=t(np.sin(a1)),
                     cos2_x=t(np.cos(a2)), sin2_x=t(np.sin(a2)),
                     level2=pilot["level2"], kd=kd)


def a2_pilot_phase(st: A2Statics, c1: torch.Tensor, s1: torch.Tensor,
                   c2: torch.Tensor, s2: torch.Tensor,
                   base_phase: torch.Tensor) -> torch.Tensor:
    """Deviation-phase contribution [B, W] of the A2 pilot: kd * running
    sum of the per-sample pilot value, with the cross-line carry in
    `base_phase` (f32 [B]; c1, s1, c2, s2 are the per-line rotations).

    Two bounds make it exact whatever the order of the f32 running sum:
    every pilot value is an integer with |val| <= level2 = 1,638, so a
    row of W <= 1,024 columns sums to |sum| < 1.7e6 < 2^24, and every
    partial sum is an integer that f32 holds; u * (1/32768) only scales
    by a power of two."""
    # mirrors XLA's CPU contraction: of a*b - c*d, c*d is rounded and a*b
    # fused into the subtraction
    C1 = fma32(c1[:, None], st.cos1_x[None, :], -(s1[:, None] * st.sin1_x))
    C2 = fma32(c2[:, None], st.cos2_x[None, :], -(s2[:, None] * st.sin2_x))
    p1 = torch.clamp(torch.floor(C1 * 32768.0), -32768, 32767)
    s1v = torch.floor(torch.floor(p1 * 0.5) * (32767.0 / 32768.0))
    u = torch.floor((s1v + 32768.0) * 0.5)
    p2 = torch.clamp(torch.floor(C2 * 32768.0), -32768, 32767)
    val = torch.floor(torch.floor(p2 * (u * (1.0 / 32768.0)))
                      * float(np.float32(st.level2 / 32768.0)))
    # base + kd * sum, fused
    return fma32(torch.cumsum(val, dim=1), float(np.float32(st.kd)),
                 base_phase[:, None].expand_as(val))


def am_add(st: FMStatics, out_i: torch.Tensor, out_q: torch.Tensor,
           seg_val: torch.Tensor,   # f32 [B, NSEG] gain (s+32768)/2
           seg_col: torch.Tensor,   # i32 [B, NSEG]
           c0: torch.Tensor,        # f32 [B] carrier rotation per line
           s0: torch.Tensor):
    """AM audio carrier (src/video.c:2359-2378): the contribution
    ((((phase>>16) * s2) >> 15) * level) >> 15, half-modulation.  The
    gain is constant over each hold segment; its telescoped f32 sum over
    the segments (the JAX package's form) adds integers below 2^24 and
    so equals the segment's own value, which is looked up."""
    B, W = out_i.shape
    cols = torch.arange(W, dtype=torch.int32, device=out_i.device)
    k = torch.searchsorted(seg_col[:, 1:].contiguous(),
                           cols.expand(B, W).contiguous(), right=True)
    val = torch.gather(seg_val, 1, k)
    del k
    # mirrors XLA's CPU contraction: of a*b +- c*d, c*d is rounded and
    # a*b fused, and the tie-break rotation cc - e*cs, cs + e*cc fuses
    # its product
    c0, s0 = c0[:, None], s0[:, None]
    cos_x, sin_x = st.cos_x[None, :], st.sin_x[None, :]
    cc = fma32(c0, cos_x, -(s0 * sin_x))
    cs = fma32(s0, cos_x, c0 * sin_x)
    if st.eps:
        e = float(np.float32(st.eps))
        cc, cs = fma32(cs, -e, cc), fma32(cc, e, cs)
    lvl = float(st.level_int)
    inv = 1.0 / 32768.0

    def mix(c):
        p = torch.clamp(torch.floor(c * 32768.0), -32768, 32767)
        return torch.floor(torch.floor(p * val * inv) * lvl * inv)
    return out_i + mix(cc), out_q + mix(cs)


def _class_windows(x: torch.Tensor, offq: np.ndarray, offr: np.ndarray,
                   m_step: int, G: int, S: int) -> torch.Tensor:
    """[P, G, S] windows into the 1-D stream x: class c's window g starts
    at offq[c]*m_step + offr[c] + g*m_step.  The offsets are host ints, so
    each window is a slice (start clamped into range, as
    jax.lax.dynamic_slice clamps it)."""
    s2 = x.reshape(-1, m_step)
    X = torch.cat([s2[:-1], s2[1:, :S]], dim=1)
    rows, cols = X.shape
    return torch.stack([
        X[r:r + G, q:q + S]
        for r, q in zip(np.clip(offq, 0, rows - G).tolist(),
                        np.clip(offr, 0, cols - S).tolist())])


def _cumsum_mod(x: torch.Tensor, M: int, bound: int) -> torch.Tensor:
    """Inclusive prefix sums mod M of int32 x with |values| < bound,
    exact in int32 via hierarchical row sums (M must be < 2^30).  The
    sums are kept in int32 explicitly: torch.cumsum of an int32 tensor
    returns int64 unless told otherwise."""
    i32 = torch.int32
    n = x.shape[0]
    C = int((2 ** 31 - 1) // max(bound, 1))
    if n <= C:
        return torch.cumsum(x, 0, dtype=i32) % M
    C = min(C, 1024)
    R = -(-n // C)
    x2 = torch.nn.functional.pad(x, (0, R * C - n)).reshape(R, C)
    within = torch.cumsum(x2, 1, dtype=i32)
    rows = within[:, -1] % M
    offs = _cumsum_mod(rows, M, M)
    offs_ex = torch.cat([offs.new_zeros(1), offs[:-1]])
    return (((within % M) + offs_ex[:, None]) % M).reshape(-1)[:n]


@dataclass
class FMWin:
    """Static config for device FM segment assembly: the zero-order hold
    segments (src/video.c:3273-3277) of all G lines of a line class form
    consecutive windows of the audio-rate held-value stream, and the
    deviation phase integral is an exact int32 prefix sum mod M (2*pi *
    deviation/(fs*32767) * X == 2*pi * (X mod M)/M when deviation divides
    fs*32767)."""
    P_a: int           # line-class period
    m_step: int        # audio pairs consumed per period
    nseg: int
    NH: int            # held-window length (multiple of m_step)
    M: int             # phase modulus
    prod_bound: int    # max |held * len|
    lens_tiled: torch.Tensor   # i32 [NH + max_len_period] hold lengths


def held_device(carrier, pcm: torch.Tensor, lim_hist: int) -> torch.Tensor:
    """Post-limiter held FM mono samples from the raw PCM window, on the
    device (mirrors AudioChain._held_values; the reference's per-sample
    audio pipeline, src/video.c:3280-3330)."""
    t = pcm[:, 0].to(torch.int32) + pcm[:, 1].to(torch.int32)
    x = torch.where(t < 0, -((-t) // 2), t // 2)   # C trunc division
    out = (carrier.limiter.device_process(x)
           if carrier.limiter is not None else x)
    return out[lim_hist:].to(torch.int16)


def fm_prepare(fw: FMWin, st: FMStatics, B: int,
               held: torch.Tensor,    # i16 [NH]
               xa: torch.Tensor,      # i32 scalar: phase accum at i0
               lens_off: int,         # i0 mod len-period
               offq: np.ndarray,      # i32 [P_a]
               offr: np.ndarray,      # i32 [P_a]
               col0: torch.Tensor,    # i32 [P_a, nseg]
               ctab: torch.Tensor,    # f32 [P_r] carrier cos table
               stab: torch.Tensor,    # f32 [P_r]
               adv: int | None = None,   # next block's i0 - i0
               ):
    """Assemble the per-line fm_add arguments on the device from the
    compact per-block upload.  With `adv`, also returns the phase anchor
    for the next block, as a device scalar (no host sync)."""
    P, S = fw.P_a, fw.nseg
    G = -(-B // P)
    h32 = held.to(torch.int32)
    lens = fw.lens_tiled[lens_off:lens_off + fw.NH]
    prod = h32 * lens
    xincl = _cumsum_mod(prod, fw.M, fw.prod_bound)
    xa_next = None
    if adv is not None:
        xa_next = ((xa + xincl[min(max(adv - 1, 0), fw.NH - 1)]) % fw.M
                   if adv > 0 else xa)
    # exclusive prefix + anchor: phase BEFORE each hold period
    xc = torch.cat([xincl.new_zeros(1), xincl[:-1]])
    xc = (xc + xa) % fw.M

    vwin = _class_windows(h32, offq, offr, fw.m_step, G, S)
    bwin = _class_windows(xc, offq, offr, fw.m_step, G, S)
    seg_val = vwin.transpose(0, 1).reshape(-1, S)[:B].to(torch.float32)
    # the phase at each segment start is seg_cnt * unit; fm_add fuses
    # that product, so it stays unrounded here
    seg_cnt = bwin.transpose(0, 1).reshape(-1, S)[:B].to(torch.float32)
    unit = float(np.float32(2.0 * np.pi / fw.M))

    seg_col = col0[None].expand(G, P, S).reshape(-1, S)[:B]
    args = (seg_val, seg_cnt, seg_col, ctab[:B], stab[:B], unit)
    if adv is not None:
        return args, xa_next
    return args


# ---------------------------------------------------------------------------
@dataclass
class NicamStatics:
    """Static tensors of the NICAM DQPSK synthesis (and of DANCE, which
    shares it)."""
    pulse: torch.Tensor     # f32 [P, NSLOT, W] per-class pulse matrices
    lut_i: torch.Tensor     # i16 [den] carrier LUT, exactly the
    lut_q: torch.Tensor     # reference's sin_cint16 table (common.c:209)
    den: int                # LUT length (carrier period in samples)
    period: int             # P lines
    nslot: int
    kf: np.ndarray          # i64 [P] first symbol per class (host)
    syms_per_period: int
    # taps of 2048 and more (DANCE): pulse = PULSE_SPLIT * hi + lo, each
    # part below 2048 (split_pulse); None where pulse itself is
    pulse_hi: torch.Tensor | None = None
    pulse_lo: torch.Tensor | None = None
    # nicam_add's index grids, per device, built at first use
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)


#: the scale of split_pulse's high part
PULSE_SPLIT = 64
#: taps below this magnitude are exact in every matmul precision torch
#: may pick for an f32 product (TF32 keeps 11 significant bits)
EXACT_TAP = 2048


def split_pulse(pulse: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Integer pulse taps as PULSE_SPLIT * hi + lo, with hi = round(p /
    PULSE_SPLIT) and |lo| <= PULSE_SPLIT / 2: both parts below EXACT_TAP,
    so each product with the {-1, 0, +1} signs is exact in TF32 too.
    DANCE's taps reach 13 bits (|5,605| for ntsc-bs at 16 MS/s)."""
    hi = np.round(pulse.astype(np.float64) / PULSE_SPLIT)
    lo = pulse - PULSE_SPLIT * hi
    if max(np.abs(hi).max(), np.abs(lo).max()) >= EXACT_TAP:
        raise ValueError("pulse taps too large for a two-part exact "
                         "product")
    return hi.astype(np.float32), lo.astype(np.float32)


def make_nicam_statics(taps: np.ndarray, num: int, den: int, width: int,
                       timing, device="cuda") -> NicamStatics:
    """Build the per-class pulse tensor and the carrier LUTs on the host
    (hacktv_tpu's make_nicam_statics, line for line), then on `device`.

    `timing` is a nicam.SymbolTiming.  Class c represents absolute lines
    k == c (mod P); slot s holds the pulse of symbol kf(c)+s where kf(c)
    is the first symbol whose pulse reaches into the line.

    nicam_add's f32 product is exact whatever the matmul precision: its
    operands are integers (pulse taps) and signs in {-1, 0, +1}, so with
    |tap| < 2048 even TF32's 11 significant bits hold them, every product
    is exact, and every partial sum is an integer far below 2^24 (a
    sample lies under only a few pulses).  NICAM's taps stay below 2048
    (|1,033| for PAL-I at 16 MS/s).  DANCE's reach 13 bits: their pulse
    matrix is also kept split in two parts below 2048 (split_pulse), and
    nicam_add sums two exact products, the high one scaled by 64 (exact:
    a power of two), every partial sum still an integer below 2^24 (about
    11 pulses of |5,605| at a sample).  Of the two exact ways, two f32
    products or one f64 product, this takes the first: the tensor cores'
    f32 path, and the same arithmetic as NICAM's."""
    ntaps = len(taps)
    span = timing.sps * timing.decimation - timing.dsl
    period = int(np.lcm(span, width) // width)
    syms_per_period = period * width // span * timing.decimation
    assert timing.start(syms_per_period) == period * width

    # slots: max symbols whose pulse [S, S+ntaps) intersects a line
    min_sp = timing.sps - 1
    nslot = int(np.ceil((width + ntaps - 1) / min_sp)) + 2

    # The pattern is computed one period in (line (c+P)*W) so that pulse
    # tails from the previous period are included; kf[c] is stored
    # relative to the first period and may be negative for the very first
    # lines of the stream (masked by the caller).
    pulse = np.zeros((period, nslot, width), dtype=np.float32)
    kf = np.zeros(period, dtype=np.int64)
    for c in range(period):
        line_start = (c + period) * width
        # first symbol with S_k + ntaps > line_start
        k = max(0, (line_start - ntaps) // timing.sps - 2)
        while int(timing.start(k)) + ntaps <= line_start:
            k += 1
        kf[c] = k - syms_per_period
        for s in range(nslot):
            off = int(timing.start(k + s)) - line_start
            if off >= width:
                break
            lo = max(0, off)
            hi = min(width, off + ntaps)
            pulse[c, s, lo:hi] = taps[lo - off: hi - off]
    split = (split_pulse(pulse) if np.abs(pulse).max() >= EXACT_TAP
             else None)

    # the reference's carrier LUT: round(cos(d*i)*32767) over one full
    # period, pointer wrapping at den (src/common.c:209-226,
    # src/nicam728.c:312, src/dance.c:412-416), so the int32 mix in
    # nicam_add is bit-exact
    d = 2.0 * np.pi / den * num
    i = np.arange(den, dtype=np.float64)
    lr = lambda a: np.where(a >= 0, np.floor(a + 0.5), np.ceil(a - 0.5))
    t = lambda a: torch.as_tensor(a, device=device)
    return NicamStatics(
        pulse=t(pulse),
        lut_i=t(lr(np.cos(d * i) * 32767.0).astype(np.int16)),
        lut_q=t(lr(np.sin(d * i) * 32767.0).astype(np.int16)),
        den=den, period=period, nslot=nslot, kf=kf,
        syms_per_period=syms_per_period,
        pulse_hi=t(split[0]) if split else None,
        pulse_lo=t(split[1]) if split else None)


def window_starts(st: NicamStatics, offq: np.ndarray, offr: np.ndarray,
                  L: int, block_lines: int) -> np.ndarray:
    """nicam_add's window start of each line class (int64 [P]) in a block
    of `block_lines` lines, into sign streams of L symbols: clamped into
    range, as the reference's dynamic_slice clamps them."""
    spp, S = st.syms_per_period, st.nslot
    rows, cols = L // spp - 1, spp + S
    G = -(-block_lines // st.period)
    return (np.clip(offq, 0, rows - G).astype(np.int64) * spp
            + np.clip(offr, 0, cols - S))


def nicam_add(st: NicamStatics, out_i: torch.Tensor, out_q: torch.Tensor,
              signs_i: torch.Tensor,   # f32 [L] per-symbol I signs (padded)
              signs_q: torch.Tensor,   # f32 [L] per-symbol Q signs
              offq: np.ndarray,        # i32 [P] window row per line class
              offr: np.ndarray,        # i32 [P] window column per class
              cc_off: torch.Tensor,    # i32 [B] carrier LUT offset per line
              k0_mod: int,             # first line's class offset
              line0: int = 0,          # the first line's index in its block
              block_lines: int | None = None,   # the block's lines
              starts: torch.Tensor | None = None,   # i64 [P] (window_starts)
              ):
    """Add the NICAM DQPSK burst to the (I, Q) block [B, W].

    Lines of the same class c (k = c mod P) consume exactly
    syms_per_period (spp) symbols per period, so the amplitudes of all G
    lines of a class form a [G, NSLOT] window into the sign stream at
    stride spp.  The windows of both streams and all classes come from
    one gather (a static [2, G, S] index grid plus the P window starts,
    uploaded per block) and go through one batched product with the
    pulse matrices; the sign buffer is zero-prepadded by one period so
    pre-stream symbols read 0.  Window starts are clamped into range, as
    the reference's dynamic_slice clamps them.

    With `line0`, out_i and out_q are the lines [line0, line0 + B) of a
    block of `block_lines` lines (one shard of it): the window starts are
    the block's, clamped as for the whole block, and each class of the
    shard reads its windows from the block line it starts at.

    `starts` are a whole block's window starts (`window_starts`) already
    on the device, so that the step uploads nothing (a replayed CUDA graph
    cannot); without them they are uploaded here."""
    B, W = out_i.shape
    P, S = st.period, st.nslot
    spp = st.syms_per_period
    L = signs_i.shape[0]
    G = -(-B // P)
    dev = out_i.device

    key = ("grid", G, L, str(dev))
    grid = st._cache.get(key)
    if grid is None:
        g = np.arange(G, dtype=np.int64)[:, None] * spp + np.arange(S)
        grid = st._cache[key] = torch.as_tensor(np.stack([g, g + L]),
                                                device=dev)
    if starts is None:
        start = window_starts(st, offq, offr, L,
                              B if block_lines is None else block_lines)
        if line0:
            # the shard's class c' is the block's class (c' + line0) mod
            # P, its window g' the block's window g' + (c' + line0) // P
            c = np.arange(P, dtype=np.int64) + line0
            start = start[c % P] + (c // P) * spp
        starts = transfer.upload(start, dev)
    if line0:
        k0_mod = (k0_mod + line0) % P
    idx = starts[:, None, None, None] + grid
    if line0:
        # the windows of lines past the block read nothing it keeps
        idx = idx.clamp_(max=2 * L - 1)
    win = torch.stack([signs_i, signs_q]).reshape(-1)[idx]   # [P, 2, G, S]
    # batched over the line class c: [P, 2G, S] x [P, S, W] -> [P, 2G, W];
    # line b = g*P + c
    w = win.reshape(P, 2 * G, S)
    roll = lambda a: torch.roll(a, -k0_mod, dims=0)
    if st.pulse_hi is None:
        bb = torch.bmm(w, roll(st.pulse))
    else:
        # taps of 2048 and more: two exact products (make_nicam_statics)
        bb = (torch.bmm(w, roll(st.pulse_hi)) * PULSE_SPLIT
              + torch.bmm(w, roll(st.pulse_lo)))
    bb = bb.view(P, 2, G, W).permute(1, 2, 0, 3).reshape(2, G * P, W)[:, :B]

    # exact reference mix (cint16_mula, src/common.h:69-78): the
    # baseband accumulators wrap to int16, the products are int32 and
    # the shift is arithmetic
    cols_w = torch.arange(W, dtype=torch.int32, device=dev)
    lut = (cc_off[:, None] + cols_w) % st.den
    cci = st.lut_i[lut].to(torch.int32)
    ccq = st.lut_q[lut].to(torch.int32)
    bi, bq = ((bb.to(torch.int32) + 0x8000) & 0xFFFF) - 0x8000
    out_i = out_i + ((bi * cci - bq * ccq) >> 15).to(torch.float32)
    out_q = out_q + ((bi * ccq + bq * cci) >> 15).to(torch.float32)
    return out_i, out_q
