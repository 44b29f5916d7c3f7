"""The port's measurement entry points (hacktv_tpu_torch.bench,
hacktv_tpu_torch.tools.service_bench and .profile_bench) against the JAX
package's bench.py and tools/, on the CPU at one frame a block.

The `--e2e file` sink of each bench form (i, i --dynamic, ntsc-vsb,
secam, dmac with the pipelined multiplex, mux2) holds the JAX package's
encode_block_device -> collect_block of the same blocks, byte for byte.
bench.py's own `_bench_config` and tools/service_bench.py's `bench_one`
(loaded by path, their encoders and sink stood in for by fakes that
record each call) give the JSON lines' keys and metric strings, and the
order of dispatches, collections and writes, which the port's must
equal.  Without a card each entry point raises unless given
`--device cpu`, and importing them loads neither jax nor hacktv_tpu.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _torch_common as tc
import hacktv_tpu
import hacktv_tpu.mux
import hacktv_tpu.runtime
import hacktv_tpu.video.mac
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu.av.testcard import TestCardSource as JTestCard
from hacktv_tpu.config.standards import get_mode as jget_mode
from hacktv_tpu.mux import MuxEncoder as JMuxEncoder
from hacktv_tpu.video.mac import MacEncoder as JMacEncoder
from hacktv_tpu_torch import Encoder, bench
from hacktv_tpu_torch import runtime as trt
from hacktv_tpu_torch.tools import profile_bench, service_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's forms that the port's must equal: --mode all's runs, mux2
# and i --dynamic
FORMS = [(name, e2e, False) for name, e2e in bench.ALL_RUNS] + [
    ("mux2", None, False), ("i", None, True)]


def _by_path(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbench():
    return _by_path("bench.py", "_jax_bench")


class JDyn(JTestCard):
    """bench.py's `_Dyn`, built the same way from hacktv_tpu's test
    card: seeded noise for sound."""

    def __init__(self, width, height):
        super().__init__(width, height)
        self._NOISE = np.random.default_rng(11).integers(
            -20000, 20000, (120 * 32000, 2)).astype(np.int16)

    def read_audio(self, start, count):
        n = len(self._NOISE)
        i = start % n
        if i + count <= n:
            return self._NOISE[i:i + count]
        return np.concatenate([self._NOISE[i:],
                               self._NOISE[:i + count - n]])


def _jax_encoder(name, dynamic, fpb):
    """bench.py's encoder for configuration `name` at `fpb` frames."""
    tc.jax_runtime()
    cfg = bench._CONFIGS[name]
    mode, rate = cfg["mode"], cfg["rate"]
    kw = {"vfilter": True} if cfg.get("vfilter") else {}
    if dynamic:
        kw["source"] = JDyn(922, 576)
    if mode.startswith("dmac"):
        return JMacEncoder(jget_mode(mode), rate, 0, frames_per_block=fpb,
                           pipeline_mux=True)
    if cfg.get("mux"):
        return JMuxEncoder([
            JEncoder(mode, rate, frames_per_block=fpb, offset=-2_250_000,
                     **kw),
            JEncoder(mode, rate, frames_per_block=fpb, offset=2_250_000,
                     **kw)])
    return JEncoder(mode, rate, frames_per_block=fpb, **kw)


@pytest.mark.parametrize("name,dynamic", [
    ("i", False), ("i", True), ("ntsc-vsb", False), ("secam", False),
    ("dmac", False), ("mux2", False)],
    ids=["i", "i-dynamic", "ntsc-vsb", "secam", "dmac", "mux2"])
def test_file_sink_bytes_equal_jax(name, dynamic, tmp_path):
    """One warm-up block and one trial of two: blocks 0-1 reach the
    sink (block 2 is dispatched, never collected), 0 differing
    samples."""
    path = str(tmp_path / "sink.bin")
    line = bench.bench_config(name, "file", dynamic, device="cpu", fpb=1,
                              warm=1, n_blocks=2, trials=1, sink_path=path)
    assert line["device"] == "cpu" and line["card"] is None
    j = _jax_encoder(name, dynamic, 1)
    want = []
    for b in range(2):
        out = j.collect_block(b, j.encode_block_device(b))
        assert out.ndim == 2, name          # complex: I and Q
        want.append(out)
    want = np.concatenate(want)
    got = np.fromfile(path, np.int16).reshape(-1, 2)
    tc.assert_same(got, want, f"{name} sink")


def test_real_output_sink_bytes_equal_jax(monkeypatch, tmp_path):
    """A real-output encoder (PAL composite): bench stacks a zero Q
    column before the sink, which writes I only, as bench.py does."""
    t = Encoder("pal", 16_000_000, device="cpu")
    assert not t.complex_out
    monkeypatch.setattr(bench, "make_encoder", lambda *a, **kw: t)
    path = str(tmp_path / "sink.bin")
    bench.bench_config("i", "file", device="cpu", warm=1, n_blocks=2,
                       trials=1, sink_path=path)
    tc.jax_runtime()
    j = JEncoder("pal", 16_000_000)
    want = np.concatenate([j.collect_block(b, j.encode_block_device(b))
                           for b in range(2)])
    assert want.ndim == 1
    tc.assert_same(np.fromfile(path, np.int16), want, "pal sink")


class _JaxFake:
    """A JAX encoder and its device value for bench.py's loop."""

    frames_per_block = 1
    complex_out = True
    frame_samples = 4

    def __init__(self, calls, ctor_kw):
        self.calls = calls
        self.params = SimpleNamespace(frame_samples=4)
        calls.append(("new", ctor_kw.get("frames_per_block")))

    def encode_block_device(self, b):
        self.calls.append(("encode", b))
        calls = self.calls

        class Dev:
            def block_until_ready(self):
                calls.append(("sync",))
        return Dev()

    def collect_block(self, b, dev):
        self.calls.append(("collect", b))
        return np.zeros((4, 2), np.int16)


class _TorchFake(_JaxFake):
    def encode_block_device(self, b):
        self.calls.append(("encode", b))
        return torch.zeros(4, 2, dtype=torch.int16)


class _Sink:
    def __init__(self, calls):
        self.calls = calls

    def write(self, a):
        self.calls.append(("write", len(a)))

    def close(self):
        self.calls.append(("close",))


@pytest.fixture
def fake_jax(monkeypatch, jbench):
    """bench.py with recording fakes for its encoders and sink: each
    records ("new", frames a block), ("encode", b), ("sync",),
    ("collect", b), ("write", rows), ("close",) in order."""
    calls = []

    def make(*a, **kw):
        if a and isinstance(a[0], list):         # MuxEncoder(channels)
            return a[0][0]
        return _JaxFake(calls, kw)
    for mod, attr in ((hacktv_tpu, "Encoder"),
                      (hacktv_tpu.video.mac, "MacEncoder"),
                      (hacktv_tpu.mux, "MuxEncoder")):
        monkeypatch.setattr(mod, attr, make)
    monkeypatch.setattr(hacktv_tpu.runtime, "NativeFileSink",
                        lambda *a: _Sink(calls))
    return calls


@pytest.fixture
def fake_torch(monkeypatch):
    """The port's bench with the same recording fakes."""
    calls = []

    def make(name, dynamic=False, *, device, fpb=None):
        mode = bench._CONFIGS[name]["mode"]
        return _TorchFake(calls, {"frames_per_block":
                                  fpb or bench.frames_per_block(mode)})
    monkeypatch.setattr(bench, "make_encoder", make)
    monkeypatch.setattr(trt, "NativeFileSink", lambda *a: _Sink(calls))
    return calls


def test_configs_equal_bench_py(jbench):
    assert bench._CONFIGS == jbench._CONFIGS


@pytest.mark.parametrize("name,e2e,dynamic", FORMS,
                         ids=[f"{n}-{e}{'-dyn' if d else ''}"
                              for n, e, d in FORMS])
def test_json_line_and_block_order_equal_bench_py(name, e2e, dynamic,
                                                  jbench, fake_jax,
                                                  fake_torch, monkeypatch):
    """The same keys (with `card`) and metric string, the same frames a
    block, and the same dispatches, collections, writes and close at
    bench.py's defaults (5 warm-up blocks, 3 trials of 8)."""
    with monkeypatch.context() as m:
        # bench.py deletes its sink file, which its fake sink never made
        m.setattr(os, "remove", lambda p: None)
        want = jbench._bench_config(name, e2e=e2e, dynamic=dynamic)
    got = bench.bench_config(name, e2e, dynamic, device="cpu")
    assert set(got) == set(want) | {"card"}
    assert got["metric"] == want["metric"]
    assert got["unit"] == want["unit"]
    # a mux builds two fakes; the port's fake blocks live on the CPU,
    # where there is nothing to wait for
    new = lambda calls: {c for c in calls if c[0] == "new"}
    steps = lambda calls: [c for c in calls
                           if c[0] != "new" and c != ("sync",)]
    assert new(fake_torch) == new(fake_jax)
    assert steps(fake_torch) == steps(fake_jax)
    assert fake_torch.count(("encode", 28)) == 1


def test_mux_worker_error_surfaces(monkeypatch):
    """dmac's pipelined multiplex: a failure in the worker's prefetch of
    the block after the last reaches the caller, and the worker stops."""
    enc = bench.make_encoder("dmac", device="cpu", fpb=1)
    prepare = enc._prepare_host

    def failing(b):
        if b == 2:
            raise RuntimeError("multiplex failed")
        return prepare(b)
    monkeypatch.setattr(enc, "_prepare_host", failing)
    monkeypatch.setattr(bench, "make_encoder", lambda *a, **kw: enc)
    with pytest.raises(RuntimeError, match="multiplex failed"):
        bench.bench_config("dmac", device="cpu", warm=1, n_blocks=1,
                           trials=1)
    with pytest.raises(RuntimeError, match="shutdown"):
        enc._pipe_pool.submit(print)


def test_main_all_on_cpu(fake_torch, capsys):
    """--mode all prints one line per run of ALL_RUNS; --device cpu
    takes the CPU; --d2h prints the copy-back line."""
    assert bench.main(["--mode", "all", "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert len(lines) == len(bench.ALL_RUNS)
    assert all(x["device"] == "cpu" for x in lines)
    assert bench.main(["--d2h", "--device", "cpu"]) == 0
    d2h = json.loads(capsys.readouterr().out)
    assert d2h["metric"] == "raw D2H bandwidth" and d2h["value"] > 0


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: bench.main(["--mode", "i"]),
                 lambda: bench.main(["--d2h"]),
                 lambda: service_bench.main(["--only", "syster"]),
                 lambda: profile_bench.main(["1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_card_line_raises_without_nvidia_smi(monkeypatch):
    def missing(*a, **kw):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(bench.subprocess, "run", missing)
    with pytest.raises(RuntimeError, match="power limit"):
        bench.card_line()


def test_service_table_equals_jax_tool(monkeypatch):
    """The ten configurations, and bench_one's line keys and metric
    (JAX side through a recording fake encoder)."""
    jsb = _by_path("tools/service_bench.py", "_jax_service_bench")
    assert service_bench.CONFIGS == jsb.CONFIGS
    calls = []
    monkeypatch.setattr(hacktv_tpu, "create_encoder",
                        lambda *a, **kw: _JaxFake(calls, kw))
    for label in ("syster", "eurocrypt"):
        mode, rate, kw = service_bench.CONFIGS[label]
        want = jsb.bench_one(label, mode, rate, kw, fpb=1, blocks=1,
                             trials=1, warm=1)
        got = service_bench.bench_one(label, mode, rate, kw, fpb=1,
                                      blocks=1, trials=1, warm=1,
                                      device="cpu")
        assert set(got) == set(want) and got["metric"] == want["metric"]
        assert got["value"] > 0


def test_service_out_file_only_when_asked(monkeypatch, tmp_path, capsys):
    """No --out writes nothing; --out writes the lines; --only merges."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(service_bench, "bench_one",
                        lambda label, *a, **kw: {"metric": label,
                                                 "value": 1})
    service_bench.main(["--only", "sis", "--device", "cpu"])
    assert os.listdir(tmp_path) == []
    out = tmp_path / "table.json"
    service_bench.main(["--device", "cpu", "--out", str(out)])
    service_bench.main(["--only", "sis", "--device", "cpu", "--out",
                        str(out)])
    table = json.loads(out.read_text())
    assert table["device"] == "cpu"
    assert sorted(r["metric"] for r in table["results"]) == \
        sorted(service_bench.CONFIGS)
    assert len(capsys.readouterr().out.splitlines()) == 1 + 11 + 2


def test_profile_returns_encode_block_device_blocks():
    """profile_bench's blocks 1-2 (after one warm-up block) equal a fresh
    encoder's encode_block_device blocks 1-2."""
    report, outs = profile_bench.profile(1, device="cpu", warm=1, n=2)
    assert report["fpb"] == 1 and report["host_ms"] <= report["full_ms"]
    e = Encoder("i", 16_000_000, device="cpu")
    want = [e.encode_block_device(b) for b in range(3)][1:]
    for got, ref in zip(outs, want, strict=True):
        tc.assert_same(got.numpy(), ref.numpy(), "profile block")


def test_imports_leave_jax_out():
    code = ("import sys\n"
            "import hacktv_tpu_torch.bench, "
            "hacktv_tpu_torch.tools.service_bench, "
            "hacktv_tpu_torch.tools.profile_bench\n"
            "bad = [m for m in sys.modules if m in ('jax', 'hacktv_tpu') "
            "or m.startswith(('jax.', 'hacktv_tpu.'))]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr
