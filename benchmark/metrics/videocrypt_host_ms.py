"""Videocrypt I's host coder (Videocrypt.block_arrays: the frames' PRBS
and VBI packets, the cut columns and VBI rows of the block), by the
program's counters `videocrypt.host_ns` and `videocrypt.blocks`
(hacktv_tpu_torch/telemetry.py): their totals over every block the
process ran (the counters only grow, from zero at the process's start;
the window's blocks are nearly all of them), in ms a block.  The coder
runs on the host for every block, replayed or not.  None where the
program has no such counters, or ran no Videocrypt block."""


def from_counters(counters: dict):
    ns, blocks = counters.get("videocrypt.host_ns"), counters.get(
        "videocrypt.blocks")
    if ns is None or not blocks:
        return None
    return ns / blocks / 1e6


def read(ctx):
    from hacktv_tpu_torch import telemetry
    return from_counters(telemetry.counters())
