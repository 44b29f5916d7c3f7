"""The port's tracer (hacktv_tpu_torch/telemetry.py) on the CPU: tracing
leaves an encoder's samples as they are, records nothing while off, and
while on records each block's dispatch with its five stages and its copy
back, nested and carrying the block number; the block path's uploads
are counted (PAL-I and D2-MAC); on the CPU a collect copies nothing (the
raster encoder, D2-MAC and the two-channel mux); SECAM-L's chroma program, its metadata and its AM sound are
spans of their stages, and SECAM's counters count its blocks, its time
and its metadata builds (PAL-I leaves them); Videocrypt I's host coder
is a span under the services' and its counters count its blocks, frames,
rotated lines and time (PAL-I leaves them), and the benchmark's reader of
them is silent without them; the native file sink counts
its bytes and its conversion; the spans reach an active torch.profiler's
timeline; the raw spans kept are bounded."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from hacktv_tpu_torch import Encoder, runtime, telemetry
from hacktv_tpu_torch.mux import MuxEncoder
from hacktv_tpu_torch.video.mac import MacEncoder

BLOCKS = 3
STAGES = {"dispatch.rgb", "dispatch.meta", "dispatch.audio", "dispatch.step",
          "dispatch.carry"}


@pytest.fixture(autouse=True)
def _tracer_off():
    telemetry.enable(False)
    telemetry.take()
    yield
    telemetry.enable(False)
    telemetry.take()


def _pal_i():
    return Encoder("i", 16_000_000, vfilter=True, device="cpu",
                   frames_per_block=1)


def _d2mac_fm():
    return MacEncoder("d2mac-fm", 20_250_000, device="cpu")


def _mux_i():
    """Two PAL-I transmitters 4.5 MHz apart on one 20 MS/s stream."""
    return MuxEncoder([Encoder("i", 20_000_000, offset=o, device="cpu")
                       for o in (-2_250_000, 2_250_000)])


ENCODERS = {"i": _pal_i, "d2mac-fm": _d2mac_fm, "mux-i": _mux_i}


def _run(on: bool, make=_pal_i) -> dict:
    """BLOCKS one-frame blocks of PAL-I with the VSB filter (or what
    `make` builds) through dispatch and collect, the tracer on or off:
    the samples, the uploads counted at each block's dispatch, and the
    tracer's record."""
    telemetry.take()
    telemetry.enable(on)
    try:
        enc = make()
        out, uploads = [], []
        c0 = telemetry.counters()
        for b in range(BLOCKS):
            u0 = telemetry.counters().get("uploads", 0)
            dev = enc.encode_block_device(b)
            uploads.append(telemetry.counters().get("uploads", 0) - u0)
            out.append(enc.collect_block(b, dev))
    finally:
        telemetry.enable(False)
    return {"out": out, "uploads": uploads, "rec": telemetry.take(),
            "counters": (c0, telemetry.counters())}


@pytest.fixture(scope="module")
def runs():
    return {"off": _run(False), "on": _run(True)}


def test_tracing_leaves_the_samples_unchanged(runs):
    for a, b in zip(runs["off"]["out"], runs["on"]["out"], strict=True):
        assert np.array_equal(a, b)


def test_off_records_no_span(runs):
    rec = runs["off"]["rec"]
    assert rec["totals"] == {} and rec["counts"] == {}
    assert rec["spans"] == []


def test_each_block_dispatch_has_its_stages(runs):
    spans = runs["on"]["rec"]["spans"]
    for b in range(BLOCKS):
        (d,) = [s for s in spans if s[0] == "dispatch" and s[1] == b]
        assert d[2] is None
        kids = [s for s in spans if s[2] == "dispatch" and s[1] == b]
        assert {s[0] for s in kids} == STAGES and len(kids) == len(STAGES)
        assert all(d[3] <= s[3] <= s[4] <= d[4] for s in kids)
        assert sum(s[4] - s[3] for s in kids) <= d[4] - d[3]
        (c,) = [s for s in spans if s[0] == "collect" and s[1] == b]
        (cp,) = [s for s in spans if s[0] == "collect.copy" and s[1] == b]
        assert cp[2] == "collect" and c[3] <= cp[3] <= cp[4] <= c[4]
    rec = runs["on"]["rec"]
    assert rec["counts"]["dispatch"] == BLOCKS
    assert rec["counts"]["setup.encoder"] == 1
    # NICAM and FM mono's host windows, children of dispatch.audio
    assert {s[2] for s in spans if s[0].startswith("dispatch.audio.")} \
        == {"dispatch.audio"}
    assert rec["totals"]["dispatch.audio.nicam"] <= \
        rec["totals"]["dispatch.audio"]


@pytest.mark.parametrize("name", ["i", "d2mac-fm"])
def test_uploads_counted_on_each_steady_block(runs, name):
    """Every block after the first uploads as many host arrays
    (transfer.upload), the same with the tracer on or off: PAL-I, and
    D2-MAC's one upload buffer a block."""
    if name != "i":
        runs = {"off": _run(False, ENCODERS[name]),
                "on": _run(True, ENCODERS[name])}
    for r in runs.values():
        steady = r["uploads"][1:]
        assert steady[0] > 0 and len(set(steady)) == 1
    assert runs["on"]["uploads"] == runs["off"]["uploads"]


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_cpu_collect_copies_nothing(name):
    """On the CPU, collect_block returns the step's own memory reshaped,
    with no step event and no copy through page-locked memory: the
    raster encoder, D2-MAC and the two-channel mux."""
    enc = ENCODERS[name]()
    before = telemetry.counters()
    dev = enc.encode_block_device(0)
    out = enc.collect_block(0, dev)
    assert not hasattr(dev, "_step_done")
    assert np.shares_memory(out, dev.numpy())
    assert np.array_equal(out, dev.numpy().reshape(-1, 2))
    after = telemetry.counters()
    for name in ("collect.pinned", "collect.pinned_bytes"):
        assert after.get(name, 0) == before.get(name, 0)


@pytest.mark.parametrize("dtype,complex_out", [("int16", True),
                                               ("float", False)])
def test_file_sink_counts_its_bytes(tmp_path, dtype, complex_out):
    rng = np.random.default_rng(7)
    blocks = [rng.integers(-32768, 32768, (n, 2)).astype(np.int16)
              for n in (1000, 70_001, 3)]
    path = tmp_path / "out.bin"
    s = runtime.NativeFileSink(str(path), dtype, complex_out)
    for blk in blocks:
        s.write(blk)
    s.close()
    st = s.stats()
    size = path.stat().st_size
    assert size == sum(len(b) for b in blocks) * (2 if complex_out else 1) \
        * (2 if dtype == "int16" else 4)
    assert s.stats() == st and st["bytes_in"] == size
    borrowed = dtype == "int16" and complex_out
    assert (st["convert_ns"] == 0) == borrowed and st["wait_ns"] >= 0
    assert 0 < st["peak_bytes"] <= size
    assert st["borrowed"] == (len(blocks) if borrowed else 0)


def test_span_nesting_blocks_and_counters():
    telemetry.enable(True)
    with telemetry.span("dispatch", 5):
        with telemetry.span("dispatch.step"):
            pass
    with telemetry.span("other"):
        pass
    x0 = telemetry.counters().get("x", 0)
    telemetry.count("x", 3)
    telemetry.count("x")
    assert telemetry.counters()["x"] == x0 + 4
    rec = telemetry.take()
    assert [(n, b, p) for n, b, p, _, _ in rec["spans"]] == [
        ("dispatch.step", 5, "dispatch"), ("dispatch", 5, None),
        ("other", None, None)]
    # the counters only grow: take() leaves them
    assert rec["counters"]["x"] == telemetry.counters()["x"] == x0 + 4
    assert telemetry.take()["spans"] == []
    telemetry.enable(False)
    assert telemetry.span("dispatch") is telemetry.span("collect")


def test_spans_reach_an_active_profiler():
    from torch.profiler import ProfilerActivity, profile
    telemetry.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("dispatch.audio"):
            torch.zeros(4).sum()
    assert "hacktv.dispatch.audio" in {e.name for e in prof.events()}


def test_raw_spans_are_bounded():
    telemetry.enable(True)
    for _ in range(telemetry.RAW_SPANS + 10):
        with telemetry.span("s"):
            pass
    rec = telemetry.take()
    assert len(rec["spans"]) == telemetry.RAW_SPANS
    assert rec["counts"]["s"] == telemetry.RAW_SPANS + 10


# SECAM-L at one frame a block: the metadata's period is 6 frames, so
# blocks 0-6 build it and block 7 finds it cached
SECAM_BLOCKS = 8
SECAM_COUNTERS = ("secam.step_ns", "secam.windows", "secam.meta_builds")


def _run_secam(on: bool) -> dict:
    """SECAM_BLOCKS one-frame blocks of SECAM-L with the VSB filter (the
    device chroma program, AM sound and NICAM), the tracer on or off: the
    samples, SECAM's counters after each block, and the record."""
    telemetry.take()
    telemetry.enable(on)
    try:
        enc = Encoder("l", 16_000_000, vfilter=True, device="cpu",
                      frames_per_block=1)
        assert enc.secam_device
        out, counts = [], [telemetry.counters()]
        for b in range(SECAM_BLOCKS):
            out.append(enc.collect_block(b, enc.encode_block_device(b)))
            counts.append(telemetry.counters())
    finally:
        telemetry.enable(False)
    return {"out": out, "counts": counts, "rec": telemetry.take()}


@pytest.fixture(scope="module")
def secam_runs():
    return {"off": _run_secam(False), "on": _run_secam(True)}


def test_secam_tracing_leaves_the_samples_unchanged(secam_runs):
    for a, b in zip(secam_runs["off"]["out"], secam_runs["on"]["out"],
                    strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name,parent", [
    ("dispatch.step.secam", "dispatch.step"),
    ("dispatch.step.secam.chroma", "dispatch.step.secam"),
    ("dispatch.step.secam.render", "dispatch.step.secam"),
    ("dispatch.meta.secam", "dispatch.meta"),
    ("dispatch.audio.am", "dispatch.audio")])
def test_secam_spans_nest_once_a_block(secam_runs, name, parent):
    spans = secam_runs["on"]["rec"]["spans"]
    for b in range(SECAM_BLOCKS):
        (s,) = [s for s in spans if s[0] == name and s[1] == b]
        (p,) = [p for p in spans if p[0] == parent and p[1] == b]
        assert s[2] == parent and p[3] <= s[3] <= s[4] <= p[4]
    assert secam_runs["off"]["rec"]["spans"] == []


def test_secam_counters_count_each_block(secam_runs):
    for r in secam_runs.values():
        c = r["counts"]
        for b in range(SECAM_BLOCKS):
            assert (c[b + 1].get("secam.windows", 0)
                    - c[b].get("secam.windows", 0)) == 1
            assert c[b + 1]["secam.step_ns"] > c[b].get("secam.step_ns", 0)


def test_secam_meta_builds_stop_once_the_period_is_cached(secam_runs):
    for r in secam_runs.values():
        builds = [r["counts"][b + 1].get("secam.meta_builds", 0)
                  - r["counts"][b].get("secam.meta_builds", 0)
                  for b in range(SECAM_BLOCKS)]
        assert builds == [1] * 7 + [0]


def test_pal_i_leaves_the_secam_counters(runs):
    for r in runs.values():
        c0, c1 = r["counters"]
        for name in SECAM_COUNTERS:
            assert c1.get(name, 0) == c0.get(name, 0)


VC_BLOCKS = 3
VC_COUNTERS = ("videocrypt.host_ns", "videocrypt.blocks",
               "videocrypt.frames", "videocrypt.cut_lines")


def _run_videocrypt(on: bool) -> dict:
    """VC_BLOCKS one-frame blocks of PAL-I with the VSB filter and free-
    access Videocrypt I, the tracer on or off: the samples, the counters
    after each block, and the record."""
    telemetry.take()
    telemetry.enable(on)
    try:
        enc = Encoder("i", 16_000_000, vfilter=True, device="cpu",
                      frames_per_block=1, videocrypt="free")
        out, counts = [], [telemetry.counters()]
        for b in range(VC_BLOCKS):
            out.append(enc.collect_block(b, enc.encode_block_device(b)))
            counts.append(telemetry.counters())
    finally:
        telemetry.enable(False)
    return {"out": out, "counts": counts, "rec": telemetry.take()}


@pytest.fixture(scope="module")
def videocrypt_runs():
    return {"off": _run_videocrypt(False), "on": _run_videocrypt(True)}


def test_videocrypt_tracing_leaves_the_samples_unchanged(videocrypt_runs):
    for a, b in zip(videocrypt_runs["off"]["out"],
                    videocrypt_runs["on"]["out"], strict=True):
        assert np.array_equal(a, b)


def test_videocrypt_span_nests_under_the_services(videocrypt_runs):
    name, parent = ("dispatch.audio.services.videocrypt",
                    "dispatch.audio.services")
    spans = videocrypt_runs["on"]["rec"]["spans"]
    for b in range(VC_BLOCKS):
        (s,) = [s for s in spans if s[0] == name and s[1] == b]
        (p,) = [p for p in spans if p[0] == parent and p[1] == b]
        assert s[2] == parent and p[3] <= s[3] <= s[4] <= p[4]
    assert videocrypt_runs["off"]["rec"]["spans"] == []


def test_videocrypt_counters_count_each_block(videocrypt_runs):
    # a block's rows run from the line before it to the line after it, so
    # block 0 also makes frame 2 (its last row's); each later block makes
    # the one frame after it.  573 lines a frame are rotated: the 574
    # lines that clock the PRBS, but for line 23 (left for WSS)
    for r in videocrypt_runs.values():
        c = r["counts"]
        grew = [{k: c[b + 1].get(k, 0) - c[b].get(k, 0) for k in VC_COUNTERS}
                for b in range(VC_BLOCKS)]
        assert [g["videocrypt.blocks"] for g in grew] == [1] * VC_BLOCKS
        assert [g["videocrypt.frames"] for g in grew] == \
            [2] + [1] * (VC_BLOCKS - 1)
        assert [g["videocrypt.cut_lines"] for g in grew] == \
            [573] * VC_BLOCKS
        assert all(g["videocrypt.host_ns"] > 0 for g in grew)


def test_pal_i_leaves_the_videocrypt_counters(runs):
    for r in runs.values():
        c0, c1 = r["counters"]
        for name in VC_COUNTERS:
            assert c1.get(name, 0) == c0.get(name, 0)


def test_videocrypt_host_ms_reader():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark", "metrics",
        "videocrypt_host_ms.py")
    spec = importlib.util.spec_from_file_location("videocrypt_host_ms",
                                                  path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    assert m.from_counters({"videocrypt.host_ns": 30_000_000,
                            "videocrypt.blocks": 4}) == 7.5
    assert m.from_counters({"uploads": 7, "secam.windows": 3}) is None
    assert m.from_counters({"videocrypt.host_ns": 0,
                            "videocrypt.blocks": 0}) is None
    assert m.from_counters({"videocrypt.blocks": 3}) is None
