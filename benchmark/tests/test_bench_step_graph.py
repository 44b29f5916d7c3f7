"""The reader of the step's CUDA graphs, `step_graph_replay_pct`: the
replays' share of the steps run on the card, from the program's
counters; silent where the program has none or ran no step there."""

import importlib.util
import os

import bench_common  # noqa: F401  (sys.path)

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reader():
    path = os.path.join(BENCH, "metrics", "step_graph_replay_pct.py")
    spec = importlib.util.spec_from_file_location("step_graph_replay_pct",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_step_graph_replay_pct_arithmetic():
    m = _reader()
    assert m.from_counters({"step.graph_replays": 95,
                            "step.eager": 5}) == 95.0
    assert m.from_counters({"step.eager": 3}) == 0.0
    assert m.from_counters({"step.graph_replays": 4}) == 100.0
    assert m.from_counters({"uploads": 7}) is None
    assert m.from_counters({"step.graph_replays": 0,
                            "step.eager": 0}) is None
