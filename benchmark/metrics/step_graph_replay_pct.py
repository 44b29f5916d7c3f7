"""The block step replayed as a CUDA graph (Encoder's step graphs,
hacktv_tpu_torch/step_graph.py), by the program's counters
`step.graph_replays` and `step.eager` (hacktv_tpu_torch/telemetry.py):
the replays' share of every step run on the card over the process (the
counters only grow, from zero at the process's start; the window's
blocks are nearly all of them), in %.  None where the program has no
such counters, or ran no step on a card."""


def from_counters(counters: dict):
    replays = counters.get("step.graph_replays")
    eager = counters.get("step.eager")
    if replays is None and eager is None:
        return None
    steps = (replays or 0) + (eager or 0)
    if not steps:
        return None
    return 100.0 * (replays or 0) / steps


def read(ctx):
    from hacktv_tpu_torch import telemetry
    return from_counters(telemetry.counters())
