"""The card's busy time per block: the union of its kernels' and copies'
intervals over a profiled stretch of blocks, divided by the blocks."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["blocks"] or t["busy_s"] <= 0:
        return None
    return t["busy_s"] / t["blocks"] * 1e3
