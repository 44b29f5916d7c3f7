"""Waits of the host for the card inside the block dispatch (the enqueue):
torch.cuda.set_sync_debug_mode("warn") warnings over a stretch of blocks,
per block."""


def read(ctx):
    s = ctx.get("syncs")
    if not s or not s["blocks"]:
        return None
    return s["count"] / s["blocks"]
