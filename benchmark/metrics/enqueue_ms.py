"""The block dispatch (Encoder.encode_block_device), by the host
clock over the window: the total of every call divided by the window's
blocks, in ms."""


def read(ctx):
    s = ctx["spans"].get("enqueue")
    if s is None or not ctx["blocks"]:
        return None
    return s / ctx["blocks"] * 1e3
