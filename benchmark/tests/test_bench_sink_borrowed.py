"""The reader of the file sink's borrowed writes, `sink_borrowed_pct`:
the share of the sink's writes written from the caller's array, from the
program's counters; silent where the program has none or wrote
nothing."""

import importlib.util
import os

import bench_common  # noqa: F401  (sys.path)

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reader():
    path = os.path.join(BENCH, "metrics", "sink_borrowed_pct.py")
    spec = importlib.util.spec_from_file_location("sink_borrowed_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sink_borrowed_pct_arithmetic():
    m = _reader()
    assert m.from_counters({"sink.borrowed": 95,
                            "sink.converted": 5}) == 95.0
    assert m.from_counters({"sink.converted": 3}) == 0.0
    assert m.from_counters({"sink.borrowed": 4}) == 100.0
    assert m.from_counters({"uploads": 7}) is None
    assert m.from_counters({"sink.borrowed": 0,
                            "sink.converted": 0}) is None
