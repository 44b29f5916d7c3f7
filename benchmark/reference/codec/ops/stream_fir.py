"""The stream FIR (the video output filter) in plain PyTorch.

    y[k] = sum_t taps[nt-1-t] * xs[k+t]     for k in [0, n)

accumulated in f32 in tap order with a fused multiply-add per step.  With
r = taps reversed, the first step fuses one of the two products of the
first add and rounds the other:

    acc = fma(r[1], xs[k+1], round(r[0] * xs[k]))   if r[0] < 0 < r[1]
    acc = fma(r[0], xs[k],   round(r[1] * xs[k+1])) otherwise

and then acc = fma(r[t], xs[k+t], acc) for t = 2..nt-1: the arithmetic
of the upstream C filter as the reference compiler emits it.  `dtype`
computes the chain in a lower precision (the benchmark's control).
"""

from __future__ import annotations

import torch


def fuse_second(r0: float, r1: float) -> bool:
    """Whether the first step of the tap chain fuses the second product
    (r1 * x1) rather than the first: when r0 < 0 < r1."""
    return r0 < 0.0 < r1


def stream_fir(xs: torch.Tensor, taps_r: torch.Tensor,
               taps_i: torch.Tensor | None, n: int, dtype=None):
    """y (real taps) or (yi, yq) (complex taps) for k in [0, n): one
    addcmul (a fused multiply-add per sample) per tap."""
    src = xs if dtype is None else xs.to(dtype)

    def chain(taps):
        rh = taps.cpu().flip(0)
        r = rh.to(device=xs.device, dtype=src.dtype)
        if r.shape[0] == 1:
            acc = r[0] * src[0:n]
        elif fuse_second(float(rh[0]), float(rh[1])):
            acc = torch.addcmul(r[0] * src[0:n], src[1:n + 1], r[1])
        else:
            acc = torch.addcmul(r[1] * src[1:n + 1], src[0:n], r[0])
        for t in range(2, r.shape[0]):
            acc = torch.addcmul(acc, src[t:t + n], r[t])
        return acc.to(torch.float32)

    if taps_i is None:
        return chain(taps_r)
    return chain(taps_r), chain(taps_i)
