"""The file sink's borrowed writes (runtime.NativeFileSink), by the
program's counters `sink.borrowed` and `sink.converted`
(hacktv_tpu_torch/telemetry.py): the share of the sink's writes that its
writer thread wrote straight from the caller's array, with no copy or
conversion, over the process (the counters only grow, from zero at the
process's start; the window's blocks are nearly all of them), in %.
None where the program has no such counters, or wrote nothing."""


def from_counters(counters: dict):
    borrowed = counters.get("sink.borrowed")
    converted = counters.get("sink.converted")
    if borrowed is None and converted is None:
        return None
    writes = (borrowed or 0) + (converted or 0)
    if not writes:
        return None
    return 100.0 * (borrowed or 0) / writes


def read(ctx):
    from hacktv_tpu_torch import telemetry
    return from_counters(telemetry.counters())
