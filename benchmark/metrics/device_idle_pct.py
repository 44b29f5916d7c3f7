"""The card's idle share of a profiled stretch of blocks: 1 minus the
union of its kernels' and copies' intervals over the stretch's wall time,
in %."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
