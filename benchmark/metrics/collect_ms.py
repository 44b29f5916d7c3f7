"""The copy back (Encoder.collect_block: the wait for the card, the
copy, and the FM-video recurrence where the mode has one), by the host
clock over the window: the total of every call divided by the window's
blocks, in ms."""


def read(ctx):
    s = ctx["spans"].get("collect")
    if s is None or not ctx["blocks"]:
        return None
    return s / ctx["blocks"] * 1e3
