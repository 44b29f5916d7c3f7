"""The card's peaks and the stream FIR's work, counted from its shapes.

The peaks are NVIDIA's data-sheet figures for the H100 SXM: HBM3 at
3.35 TB/s, and 67 TFLOP/s of f32 outside the tensor cores.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flop_per_s": 67e12},
}


def peaks(kind: str) -> dict | None:
    """The peaks of the card named `kind`, or None for a card the table
    does not hold."""
    return PEAKS.get(kind)


def fir_work(n: int, nt: int, nout: int) -> tuple:
    """(bytes, FLOP) of one stream-FIR pass: n outputs per channel, nt
    taps, nout channels (2 for complex taps).  The input is read once
    (n + nt - 1 floats), the taps once per channel, each output written
    once; a multiply-add per tap and output."""
    nbytes = 4 * ((n + nt - 1) + nout * nt + nout * n)
    flops = 2 * nt * n * nout
    return nbytes, flops


def fir_bound_s(n: int, nt: int, nout: int, kind: str) -> float | None:
    """The pass's least time on card `kind`: its bytes at the memory's
    peak or its operations at the f32 peak, whichever is longer."""
    pk = peaks(kind)
    if pk is None:
        return None
    nbytes, flops = fir_work(n, nt, nout)
    return max(nbytes / pk["hbm_bytes_per_s"], flops / pk["f32_flop_per_s"])


def kernel_roofline_pct(ctx: dict, kernel, nout: int) -> float | None:
    """The stream FIR's share of its roofline in a traced stretch: the
    least time of its passes (fir_bound_s from the stage's shapes) over
    the device time of the kernels whose names `kernel` (a compiled
    pattern) finds, in %; None where the stage or the kernels are not on
    the path, or the card is not in the table."""
    t, fir = ctx.get("trace"), ctx.get("fir")
    if not t or not fir or fir["nout"] != nout:
        return None
    secs = count = 0
    for name, (s, c) in t["ops"].items():
        if kernel.search(name):
            secs += s
            count += c
    bound = fir_bound_s(fir["n"], fir["taps"], nout, ctx["kind"])
    if not count or secs <= 0 or bound is None:
        return None
    return 100.0 * count * bound / secs
