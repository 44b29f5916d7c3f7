"""The metrics' arithmetic: the rate over the whole window, the 90th
percentile over all blocks, the stream FIR's work, the readers."""

import re
import types

import pytest

import bench_common  # noqa: F401  (sys.path)
from harness import peaks, stats
from harness.manifest import reader


def test_rate_is_over_the_whole_window():
    # 3 writes of 100 samples; the window runs from its start (t0 = 10)
    # to the return of its last write (14), stalls included
    assert stats.window_rate(300, 10.0, 14.0) == 75.0


def test_gaps_start_at_the_window():
    assert stats.gaps(1.0, [1.5, 3.0, 3.25]) == [0.5, 1.5, 0.25]


def test_p90_over_all_blocks():
    vals = list(range(1, 101))          # every block, no trimming
    assert stats.percentile(vals, 90) == pytest.approx(90.1)
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([1.0, 2.0, 100.0, 3.0], 90) == \
        pytest.approx(70.9)


@pytest.mark.parametrize("n,nt,nout", [(16 * 625 * 1024, 51, 2),
                                       (16 * 625 * 1296, 67, 1)])
def test_fir_work_is_chip_smokes_formula(n, nt, nout):
    nbytes, flops = peaks.fir_work(n, nt, nout)
    assert nbytes == 4 * ((n + nt - 1) + nout * nt + nout * n)
    assert flops == 2 * nt * n * nout
    kind = "NVIDIA H100 80GB HBM3"
    assert peaks.fir_bound_s(n, nt, nout, kind) == max(
        nbytes / 3.35e12, flops / 67e12)
    assert peaks.fir_bound_s(n, nt, nout, "another card") is None


def _ctx(ops, nout=2):
    return {"kind": "NVIDIA H100 80GB HBM3", "blocks": 4,
            "spans": {"enqueue": 0.2, "collect": 0.1},
            "syncs": {"count": 2, "blocks": 4},
            "fir": {"n": 1000, "taps": 51, "nout": nout},
            "trace": {"busy_s": 0.5, "window_s": 2.0, "blocks": 10,
                      "ops": ops, "idle": {}}}


def test_readers():
    ops = {"void stream_fir_kernel<2, 51>(float const*)": [0.002, 4],
           "elementwise": [0.5, 100]}
    ctx = _ctx(ops)
    assert reader("enqueue_ms")(ctx) == pytest.approx(50.0)
    assert reader("host_syncs_per_block")(ctx) == 0.5
    assert reader("device_busy_ms")(ctx) == pytest.approx(50.0)
    assert reader("device_idle_pct")(ctx) == pytest.approx(75.0)
    assert reader("fm_carrier_ms")(ctx) is None
    # the write gap's tail over every gap of the window; none: silent
    assert reader("write_gap_p90_ms")(
        dict(ctx, gaps_ms=[float(g) for g in range(1, 101)])) == \
        pytest.approx(90.1)
    assert reader("write_gap_p90_ms")(ctx) is None
    bound = peaks.fir_bound_s(1000, 51, 2, ctx["kind"])
    assert reader("fir_cplx_roofline_pct")(ctx) == pytest.approx(
        100 * 4 * bound / 0.002)
    # a kernel off the path, or the other kind of filter: silent
    assert reader("fir_real_roofline_pct")(ctx) is None
    assert reader("fir_cplx_roofline_pct")(_ctx({"x": [1.0, 1]})) is None
    # an encoder without a stream FIR (MAC, mux): no shape, silent
    assert reader("fir_cplx_roofline_pct")(dict(ctx, fir=None)) is None


def test_trace_reduction():
    from harness import trace
    ev = [("bench.window", False, 0.0, 100.0),
          ("bench.collect", False, 10.0, 60.0),
          ("bench.sink_write", False, 60.0, 100.0),
          ("k1", True, 0.0, 20.0), ("k2", True, 15.0, 30.0),
          ("k1", True, 70.0, 80.0), ("k3", True, 95.0, 120.0),
          ("bench.collect", True, 10.0, 60.0)]    # the span's mirror
    red = trace.reduce_events(ev, 2)
    assert red["busy_s"] == pytest.approx(45e-6)
    assert red["window_s"] == pytest.approx(100e-6)
    # idle 30-70 (collect until 60, then the sink) and 80-95 (the sink)
    assert red["idle"] == pytest.approx({"collect": 30e-6,
                                         "sink_write": 25e-6})
    bd = trace.breakdown(red)
    assert [n for n, _ in bd["device_ops"]] == ["k1", "k2", "k3"]
    assert re.match("collect", bd["idle_gaps"][0][0])


def test_continuity_gap_counts_broken_chains():
    from harness import check
    init = {"v": ((1, 2, 3), 0)}
    a, b, c = ((4, 5, 6), 10), ((7, 8, 9), 20), ((1, 1, 1), 30)

    def gap(reads):
        # check.Chain over reads (block, start, end) of one follow "v"
        enc = types.SimpleNamespace(x=types.SimpleNamespace(
            _state=init["v"][0], n=init["v"][1]))
        chain = check.Chain({"v": ("x", "collect")}, enc)
        for blk, start, end in reads:
            enc.x._state, enc.x.n = end
            chain.link(enc, "collect", blk, {"v": start})
        return chain.gap + chain.initial_gap(init)
    chain = [(0, init["v"], a), (1, a, b), (2, b, c)]
    assert gap(chain) == 0
    # block 1 started afresh: three phase components and the sample differ
    reset = [chain[0], (1, init["v"], b), chain[2]]
    assert gap(reset) == 4
    assert gap([(0, a, b)]) == 4
    assert gap([(2, b, c)]) == 4


def test_bytes_short():
    from harness import check
    assert check.bytes_short(400, 1000, 1400) == 0
    assert check.bytes_short(400, 1000, 1500) == 0     # other writes
    assert check.bytes_short(400, 1000, 1200) == 200
    assert check.bytes_short(400, None, 1200) == 400
    w = check.bytes_written()
    assert w is None or w >= 0


def test_a_short_sink_fails_max_abs_diff():
    from harness import check

    class Reference:
        def initial_states(self):
            return {}
    chain = check.Chain({}, None)
    assert check.compare({}, chain, Reference()) == {"max_abs_diff": 0}
    assert check.compare({}, chain, Reference(),
                         sink_short=4)["max_abs_diff"] == 65536
