"""NICAM-728 bit-domain encoder on the device.

Port of hacktv_tpu/audio/nicam_dev.py: the frame encoder and the DQPSK
differential stream of the reference (src/nicam728.c:36-249) as torch
integer ops on one device.  Every step is exact integer arithmetic: J.17
FIR, scale-factor search, companding, parity, interleave, PRN whitening,
the differential cumsum.  The host supplies the raw PCM window for the
block's frames and a few host ints (frame index mod 16, output placement,
symbols to keep); the differential-state carry is a device scalar, so no
step waits for the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import nicam as nm


@dataclass
class NicamDevStatics:
    """Static configuration of the device encoder."""
    nf_max: int          # frames encoded per block call (padded, fixed)
    L: int               # sign-buffer length (multiple of spp)
    spp: int             # symbols per line-class period
    mode_bits: int       # (mode << 4) | (reserve << 3)
    taps: torch.Tensor   # i32 [83] J.17 taps
    perm: torch.Tensor   # i32 [728] bit permutation into (header ++ payload)
    prn: torch.Tensor    # i64 [91] PRN whitening bytes (byte 0 = 0)


def make_dev_statics(nf_max: int, L: int, spp: int,
                     mode: int = nm.MODE_STEREO, reserve: int = 1,
                     device="cuda") -> NicamDevStatics:
    perm = np.empty(nm.NICAM_FRAME_BITS, dtype=np.int32)
    perm[:24] = np.arange(24)
    perm[24 + nm._ILEAVE] = 24 + np.arange(704)
    prn = np.concatenate([[0], nm._PRN.astype(np.int32)])
    t = lambda a: torch.as_tensor(a, device=device)
    return NicamDevStatics(
        nf_max=nf_max, L=L, spp=spp,
        mode_bits=((mode & 7) << 4) | ((reserve & 1) << 3),
        taps=t(nm.J17_TAPS.astype(np.int32)), perm=t(perm), prn=t(prn))


def _j17(st: NicamDevStatics, x: torch.Tensor) -> torch.Tensor:
    """Causal J.17 FIR with int16 wrap (src/nicam728.c:147-162), for each
    row of x (int [C, N]): out[n] = wrap16((sum_j x[n-82+j] * taps[j])
    >> 15).

    One f64 convolution instead of the reference's 83 multiply-adds: each
    product is an integer below 2^30 and every partial sum is below
    sum|taps| * 32767 ~ 1.55e9, far under 2^53, so the f64 sum is the
    exact integer in any order; the round() guards an algorithm that is
    not exact (an FFT convolution errs far below 0.5 here).  Then an
    arithmetic >> 15 in int64 and the int16 wrap, as the reference's
    int16_t assignment."""
    ntaps = st.taps.shape[0]
    xp = F.pad(x.to(torch.float64)[:, None, :], (ntaps - 1, 0))
    acc = F.conv1d(xp, st.taps.to(torch.float64).view(1, 1, -1))[:, 0]
    acc = torch.round(acc).to(torch.int64) >> 15
    return (((acc + 0x8000) & 0xFFFF) - 0x8000).to(torch.int32)


def _scale_factors(blocks: torch.Tensor) -> torch.Tensor:
    """[NF, 32] int32 -> [NF] scale index (see nicam.scale_factor_indices)."""
    s = torch.where(blocks < 0, ~blocks, blocks)
    bl = torch.zeros_like(s)
    v = s
    for shift in (8, 4, 2, 1):
        hit = v >= (1 << shift)
        bl = bl + torch.where(hit, shift, 0)
        v = torch.where(hit, v >> shift, v)
    bl = bl + (s > 0).to(torch.int32)
    need = torch.clamp(bl - 8, 1, 7)
    return need.amax(dim=-1)


def _compand(ch: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """10-bit companding with parity and scale-factor signalling of one
    channel's [NF, 32] samples at scale index b [NF]."""
    # _SHIFT = [2,2,2,2,3,4,5,6][b] == max(2, b-1)
    # _FACTOR = [0,1,2,4,3,5,6,7][b] == b with 3 and 4 swapped
    sh = torch.clamp(b - 1, min=2)[:, None]
    fac = (b + (b == 3).to(b.dtype) - (b == 4).to(b.dtype))[:, None]
    v = (ch >> sh) & 0x3FF
    # parity over the 6 MSBs
    t = (v >> 4) & 0x3F
    for s in (4, 2, 1):
        t = t ^ (t >> s)
    v = v | ((t & 1) << 10)
    # scale-factor signalling on the first 54 samples (pairs 0..26)
    p = torch.arange(32, device=ch.device)
    sigb = (fac >> (2 - p % 3)[None, :]) & 1
    return v ^ torch.where(p[None, :] < 27, sigb << 10, 0)


def signs_device(st: NicamDevStatics, pcm: torch.Tensor,
                 dsym_in: torch.Tensor, famod16: int, base_off: int,
                 nkeep_syms: int):
    """Encode nf_max NICAM frames from pcm [nf_max*32 + 82, 2] (int,
    history first) and return (signs_i [L], signs_q [L], dsym_out).

    The differential sign stream is placed into a zero buffer at
    base_off (clamped so that it fits, as jax.lax.dynamic_update_slice
    clamps); dsym_out (an int32 device scalar) is the state after
    nkeep_syms symbols, the anchor handed to the next block.  signs_i and
    signs_q are the two rows of one [2, L] buffer."""
    NF = st.nf_max
    hist = nm.J17_NTAPS - 1
    dev = pcm.device
    i32 = torch.int32
    ar = lambda n: torch.arange(n, dtype=i32, device=dev)

    lr = _j17(st, pcm.t())[:, hist:].reshape(2, NF, 32)
    # interleave L/R: sample x of the 64-slot frame reads
    # concat(L, R)[x//2 + 32*(x&1)]
    x = ar(64)
    v = torch.cat([_compand(lr[0], _scale_factors(lr[0])),
                   _compand(lr[1], _scale_factors(lr[1]))],
                  dim=1)[:, x // 2 + 32 * (x & 1)]

    # header (FAW + control bits); c0 depends on the frame index mod 16
    c0 = 1 - (((famod16 + ar(NF)) >> 3) & 1)
    hdr = (nm.NICAM_FAW << 16) | ((c0 << 7) | st.mode_bits) << 8
    hdr_bits = (hdr[:, None] >> (23 - ar(24))) & 1

    # payload bits, LSB first per 11-bit sample word
    bits = (v[:, :, None] >> ar(11)) & 1
    full = torch.cat([hdr_bits, bits.reshape(NF, 704)], dim=1)
    frame_bits = full[:, st.perm]                  # static interleave

    # pack to bytes + PRN whitening (bytes 1..90)
    w = 1 << (7 - ar(8))
    by = (frame_bits.reshape(NF, 91, 8) * w).sum(-1) ^ st.prn

    # 2-bit symbols, USB first; STEP mapping 0,3,1,2 by bit arithmetic
    pairs = ((by[:, :, None] >> (6 - 2 * ar(4))) & 3).reshape(-1)
    b0 = pairs & 1
    b1 = pairs >> 1
    steps = 3 * b0 + b1 - 2 * b0 * b1
    # torch.cumsum of int32 is int64: the & 3 brings it back to 0..3
    dsym = ((dsym_in + torch.cumsum(steps, 0)) & 3).to(i32)
    sym = dsym ^ (dsym >> 1)                       # SYMS gray mapping

    n = dsym.shape[0]
    dsym_out = (dsym[min(max(nkeep_syms - 1, 0), n - 1)]
                if nkeep_syms > 0 else dsym_in.to(i32))

    signs = torch.zeros((2, st.L), dtype=torch.float32, device=dev)
    off = min(max(base_off, 0), st.L - n)
    bit = torch.stack([sym & 1, sym & 2]) != 0
    signs[:, off:off + n] = torch.where(bit, 1.0, -1.0)
    return signs[0], signs[1], dsym_out
