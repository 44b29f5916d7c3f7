"""Stream FIR (the video output filter): Hopper kernel and plain version.

Port of hacktv_tpu/ops/pallas_fir.py.  `stream_fir` keeps the JAX
signature and layout: xs holds n + nt - 1 samples and

    y[k] = sum_t taps[nt-1-t] * xs[k+t]     for k in [0, n)

accumulated in f32 in tap order with a fused multiply-add per step.  With
r = taps reversed, the first step fuses one of the two products of the
first add and rounds the other:

    acc = fma(r[1], xs[k+1], round(r[0] * xs[k]))   if r[0] < 0 < r[1]
    acc = fma(r[0], xs[k],   round(r[1] * xs[k+1])) otherwise

and then acc = fma(r[t], xs[k+t], acc) for t = 2..nt-1.  That is the
arithmetic the JAX reference's CPU backend emits for its `acc = r0*x0;
acc = acc + r1*x1; ...` chain (its compiler turns `a*x + (-b)*y` into a
subtraction and fuses the leading product), so both versions here match
it bit for bit on I, Q and the real output.  Complex taps (taps_i given)
produce I and Q from one pass over xs.

A tensor on the CPU goes to the plain version (`stream_fir_plain`, a torch
`addcmul` chain in the same tap order).  A CUDA tensor launches the kernel
of csrc/stream_fir.cu or raises; there is no fallback.  Each kernel wrapper
counts its launches in the tracer's counter "<name>.launches"
(telemetry.py).

The kernel takes its taps by value, from the host: on the card path the
taps must be CPU tensors (the encoder keeps them there), as the JAX
stream_fir takes numpy taps.  Taps on the card are refused: copying them
back would wait for the card at every launch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import telemetry
from . import cuda_build

MAX_TAPS = 256          # taps a launch passes by value (csrc kMaxTaps)
_fn = None              # stream_fir_launch, bound at the first launch


def fuse_second(r0: float, r1: float) -> bool:
    """Whether the first step of the tap chain fuses the second product
    (r1 * x1) rather than the first: when r0 < 0 < r1 (see the module
    docstring)."""
    return r0 < 0.0 < r1


def stream_fir_plain(xs: torch.Tensor, taps_r: torch.Tensor,
                     taps_i: torch.Tensor | None, n: int):
    """Plain PyTorch version: one addcmul (a fused multiply-add per
    sample) per tap, in the kernel's order."""
    def chain(taps):
        rh = taps.cpu().flip(0)
        r = rh.to(xs.device)
        if r.shape[0] == 1:
            return r[0] * xs[0:n]
        if fuse_second(float(rh[0]), float(rh[1])):
            acc = torch.addcmul(r[0] * xs[0:n], xs[1:n + 1], r[1])
        else:
            acc = torch.addcmul(r[1] * xs[1:n + 1], xs[0:n], r[0])
        for t in range(2, r.shape[0]):
            acc = torch.addcmul(acc, xs[t:t + n], r[t])
        return acc

    if taps_i is None:
        return chain(taps_r)
    return chain(taps_r), chain(taps_i)


def _check(xs: torch.Tensor, taps: list, n: int) -> int:
    nt = taps[0].shape[0]
    if xs.dtype != torch.float32 or xs.dim() != 1 or not xs.is_contiguous():
        raise ValueError("stream_fir: xs must be a contiguous 1-D float32 "
                         "tensor")
    if xs.shape[0] < n + nt - 1:
        raise ValueError(f"stream_fir: xs has {xs.shape[0]} samples, "
                         f"needs n + nt - 1 = {n + nt - 1}")
    if nt < 1 or nt > MAX_TAPS:
        raise ValueError(f"stream_fir: {nt} taps; 1 to {MAX_TAPS} are "
                         "supported")
    for t in taps:
        if (t.dtype != torch.float32 or t.dim() != 1 or t.shape[0] != nt
                or not t.is_contiguous() or t.device.type != "cpu"):
            raise ValueError("stream_fir: taps must be contiguous float32 "
                             f"[{nt}] tensors on the CPU (the kernel takes "
                             "them by value)")
    return nt


def bind():
    """The kernels' launch function, built and bound at the first call
    (an encoder on a card calls it at set-up)."""
    global _fn
    if _fn is None:
        fn = cuda_build.load("stream_fir").stream_fir_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(xs, taps_r, taps_i, y0, y1, n: int, nt: int) -> None:
    fn = bind()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = fn(xs.data_ptr(), taps_r.data_ptr(),
                 taps_i.data_ptr() if taps_i is not None else None,
                 y0.data_ptr(), y1.data_ptr() if y1 is not None else None,
                 n, nt, stream)
    if err:
        raise RuntimeError(f"stream_fir kernel launch failed: CUDA error "
                           f"{err}")


def kernel_config(is_complex: bool, nt: int) -> dict:
    """Registers per thread, shared memory per block and resident blocks
    per SM of the kernel a launch with these taps runs, on the current
    card."""
    fn = cuda_build.load("stream_fir").stream_fir_config
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(3)]
    err = fn(int(is_complex), nt, *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"stream_fir_config failed: CUDA error {err}")
    return dict(zip(("regs", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def fir_cplx(xs: torch.Tensor, taps_r: torch.Tensor, taps_i: torch.Tensor,
             n: int):
    """Complex-tap kernel (replaces pallas_fir._kernel_cplx): (yi, yq)."""
    nt = _check(xs, [taps_r, taps_i], n)
    yi = torch.empty(n, dtype=torch.float32, device=xs.device)
    yq = torch.empty(n, dtype=torch.float32, device=xs.device)
    _launch(xs, taps_r, taps_i, yi, yq, n, nt)
    telemetry.count("fir_cplx.launches")
    return yi, yq


def fir_real(xs: torch.Tensor, taps_r: torch.Tensor, n: int):
    """Real-tap kernel (replaces pallas_fir._kernel_real): y."""
    nt = _check(xs, [taps_r], n)
    y = torch.empty(n, dtype=torch.float32, device=xs.device)
    _launch(xs, taps_r, None, y, None, n, nt)
    telemetry.count("fir_real.launches")
    return y


def stream_fir(xs: torch.Tensor, taps_r: torch.Tensor,
               taps_i: torch.Tensor | None, n: int):
    """y (real taps) or (yi, yq) (complex taps) for k in [0, n)."""
    if xs.device.type == "cpu":
        return stream_fir_plain(xs, taps_r, taps_i, n)
    if xs.device.type != "cuda":
        raise ValueError(f"stream_fir: unsupported device {xs.device}")
    if taps_i is None:
        return fir_real(xs, taps_r, n)
    return fir_cplx(xs, taps_r, taps_i, n)
