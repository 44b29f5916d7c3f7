"""SECAM's chroma program on the host's side of the block step
(Encoder._row_stage's SECAM branch: the device chroma program's launches
and the luma band-reject's), by the program's counters `secam.step_ns`
and `secam.windows` (hacktv_tpu_torch/telemetry.py): their totals over
every block the process ran (the counters only grow, from zero at the
process's start; the window's blocks are nearly all of them), in ms a
block.  None where the program has no such counters, or ran no SECAM
block."""


def from_counters(counters: dict):
    ns, windows = counters.get("secam.step_ns"), counters.get("secam.windows")
    if ns is None or not windows:
        return None
    return ns / windows / 1e6


def read(ctx):
    from hacktv_tpu_torch import telemetry
    return from_counters(telemetry.counters())
