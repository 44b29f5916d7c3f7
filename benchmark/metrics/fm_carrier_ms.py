"""The host-exact FM carriers (runtime.FmCarrierExact.process: the sound
carrier in the enqueue, the video modulator in the copy back), by the
host clock over the window: the total of every call divided by the
window's blocks, in ms."""


def read(ctx):
    s = ctx["spans"].get("fm_carrier")
    if s is None or not ctx["blocks"]:
        return None
    return s / ctx["blocks"] * 1e3
