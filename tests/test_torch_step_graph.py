"""The block step's CUDA graphs (hacktv_tpu_torch/step_graph.py) on the
CPU: the signature keys every host value a graph would freeze and no
tensor's content; `StepGraphs` runs a signature's first step eagerly,
captures the second and replays the rest, keeps its graphs bounded,
replays the work counts and falls back to eager steps for a leaf it
cannot key.  A stand-in for the graph (`_EagerGraph`: the capture keeps
the step, each replay runs it again on the static inputs and writes its
outputs over the captured ones) drives the encoder's own wiring, PAL-I and
SECAM-L against plain encoders byte for byte.  Encoders on the CPU take
no graphs; the card's graphs are held by tests/test_torch_cuda.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hacktv_tpu_torch import Encoder, step_graph, telemetry
from hacktv_tpu_torch.audio import synth


def _args(**over):
    """A step's arguments as the encoder passes them (yuv, meta, first,
    audio), with host leaves of every kind; `over` replaces audio
    entries."""
    audio = {"nicam": {"pcm": torch.zeros(8, 2, dtype=torch.int16),
                       "famod16": 6, "offq": np.arange(5, dtype=np.int32),
                       "offr": np.arange(5, dtype=np.int32) * 3},
             "nicam_k0mod": 1, "gain": 0.5, "row1": None,
             "svc": ({"syms": torch.ones(4), "r0": np.int32(7)},)}
    audio.update(over)
    yuv = tuple(torch.full((3, 4), float(i)) for i in range(3))
    return (yuv, {"base": torch.arange(6)}, 1.0, audio)


def _key(args):
    return step_graph.signature(args, torch.device("cpu"))[0]


def test_equal_host_leaves_and_shapes_give_equal_keys():
    (k1, t1), (k2, t2) = (step_graph.signature(_args()) for _ in range(2))
    assert k1 == k2 and hash(k1) == hash(k2)
    # the tensor leaves, in walk order, are the arguments themselves
    assert len(t1) == 6 and all(a is not b for a, b in zip(t1, t2))


def test_tensor_content_does_not_change_the_key():
    a = _args()
    b = _args(nicam={**a[3]["nicam"],
                     "pcm": torch.full((8, 2), 9, dtype=torch.int16)})
    b = (tuple(t + 1 for t in b[0]), b[1], b[2], b[3])
    assert _key(a) == _key(b)


@pytest.mark.parametrize("change", [
    "host int", "nested host int", "host float", "first", "numpy offset",
    "numpy dtype", "numpy scalar", "None to int", "int to float",
    "int to bool", "zero sign", "tensor shape", "tensor dtype",
    "tensor strides", "leaf added"])
def test_a_changed_host_leaf_or_tensor_layout_changes_the_key(change):
    a = _args()
    nc = dict(a[3]["nicam"])
    if change == "host int":
        b = _args(nicam_k0mod=2)
    elif change == "nested host int":
        b = _args(nicam={**nc, "famod16": 7})
    elif change == "host float":
        b = _args(gain=0.25)
    elif change == "first":
        b = a[:2] + (0.0,) + a[3:]
    elif change == "numpy offset":
        offr = nc["offr"].copy()
        offr[3] += 1
        b = _args(nicam={**nc, "offr": offr})
    elif change == "numpy dtype":
        b = _args(nicam={**nc, "offq": nc["offq"].astype(np.int64)})
    elif change == "numpy scalar":
        b = _args(svc=({"syms": torch.ones(4), "r0": np.int32(8)},))
    elif change == "None to int":
        b = _args(row1=0)
    elif change == "int to float":
        b = _args(nicam_k0mod=1.0)
    elif change == "int to bool":
        b = _args(nicam_k0mod=True)
    elif change == "zero sign":
        a, b = _args(gain=0.0), _args(gain=-0.0)
    elif change == "tensor shape":
        b = _args(nicam={**nc, "pcm": torch.zeros(9, 2, dtype=torch.int16)})
    elif change == "tensor dtype":
        b = _args(nicam={**nc, "pcm": torch.zeros(8, 2, dtype=torch.int32)})
    elif change == "tensor strides":
        b = _args(nicam={**nc, "pcm": torch.zeros(
            2, 8, dtype=torch.int16).t()})
    else:
        b = _args(extra=3)
    assert _key(a) != _key(b)


@pytest.mark.parametrize("leaf,what", [
    (object(), "a object"), (torch.zeros(2, device="meta"), "a tensor on "
                             "meta")])
def test_a_leaf_it_cannot_key_is_named(leaf, what):
    with pytest.raises(step_graph.Unkeyable) as e:
        _key(_args(svc=({"syms": torch.ones(4), "r0": leaf},)))
    assert str(e.value).startswith("args[3]['svc'][0]['r0']: " + what)


class _EagerGraph(step_graph._Graph):
    """The graph's stand-in on the CPU: the capture keeps the step and
    runs it once for the outputs it holds; each replay runs it again on
    the static inputs and writes the outputs over the held ones, as a
    replay overwrites the graph's pool, without counting anything."""

    def _capture(self, fn, args, steps):
        self._again = lambda: fn(*args)
        return fn(*args)

    def _replay(self):
        saved = telemetry.counters()
        new = self._again()
        telemetry._counters.clear()
        telemetry._counters.update(saved)
        _overwrite(self.out, new)


def _overwrite(old, new):
    if isinstance(old, torch.Tensor):
        old.copy_(new)
    elif isinstance(old, dict):
        for k in old:
            _overwrite(old[k], new[k])
    elif isinstance(old, (tuple, list)):
        for a, b in zip(old, new, strict=True):
            _overwrite(a, b)


@pytest.fixture
def eager_graph(monkeypatch):
    monkeypatch.setattr(step_graph, "_Graph", _EagerGraph)


def _delta(c0: dict, names=("step.eager", "step.graph_captures",
                            "step.graph_replays", "step.graph_failures",
                            "fir_cplx.launches")) -> tuple:
    c1 = telemetry.counters()
    return tuple(c1.get(k, 0) - c0.get(k, 0) for k in names)


def _fn(x: torch.Tensor, scale: int):
    """A step: counts one FIR launch and returns (samples, carries)."""
    telemetry.count("fir_cplx.launches")
    return x * scale, {"z": x.sum()}


def test_first_eager_second_captured_then_replayed(eager_graph):
    sg = step_graph.StepGraphs("cpu")
    c0 = telemetry.counters()
    outs = []
    for b in range(5):
        x = torch.full((4,), float(b))
        outs.append(sg(_fn, x, 3))
        assert torch.equal(outs[-1][0], x * 3) and outs[-1][1]["z"] == 4 * b
    # eager, capture (eager too), three replays; a launch a step
    assert _delta(c0) == (2, 1, 3, 0, 5)
    # each block's outputs outlive the later replays
    for b, (y, carry) in enumerate(outs):
        assert torch.equal(y, torch.full((4,), 3.0 * b))
    # a new host value is a new signature: eager again
    c0 = telemetry.counters()
    sg(_fn, torch.ones(4), 2)
    assert _delta(c0) == (1, 0, 0, 0, 1)


def test_replays_count_the_secam_kernel_windows(eager_graph):
    """A step that ran the SECAM kernel once: each replay adds its window
    to "secam.kernel_windows" (a WORK_COUNTER), as the eager steps do."""
    def step(x):
        telemetry.count("secam.kernel_windows")
        return x + 1
    assert "secam.kernel_windows" in step_graph.WORK_COUNTERS
    sg = step_graph.StepGraphs("cpu")
    c0 = telemetry.counters()
    for _ in range(5):
        sg(step, torch.ones(3))
    assert _delta(c0, ("step.eager", "step.graph_replays",
                       "secam.kernel_windows")) == (2, 3, 5)


def test_graphs_are_bounded_and_limit_zero_stays_eager(eager_graph):
    sg = step_graph.StepGraphs("cpu", limit=2)
    for scale in (1, 2, 3):
        for _ in range(2):
            sg(_fn, torch.ones(2), scale)
    assert len(sg._graphs) == 2
    c0 = telemetry.counters()
    sg(_fn, torch.ones(2), 1)               # dropped: seen again, eager
    sg(_fn, torch.ones(2), 3)               # kept: replayed
    assert _delta(c0) == (1, 0, 1, 0, 2)
    off = step_graph.StepGraphs("cpu", limit=0)
    c0 = telemetry.counters()
    for _ in range(4):
        off(_fn, torch.ones(2), 1)
    assert _delta(c0) == (4, 0, 0, 0, 4)


def test_an_unkeyable_leaf_leaves_the_steps_eager(eager_graph, capsys):
    sg = step_graph.StepGraphs("cpu")
    c0 = telemetry.counters()
    for _ in range(3):
        sg(lambda x, o: _fn(x, 2), torch.ones(2), object())
    assert _delta(c0) == (3, 0, 0, 1, 3) and sg.limit == 0
    assert "without a CUDA graph: args[1]: a object" in capsys.readouterr().err


def test_a_step_that_cannot_be_captured_runs_eagerly(monkeypatch, capsys):
    class Refused(step_graph._Graph):
        def _capture(self, fn, args, steps):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    monkeypatch.setattr(step_graph, "_Graph", Refused)
    sg = step_graph.StepGraphs("cpu")
    c0 = telemetry.counters()
    ys = [sg(_fn, torch.ones(2), 5)[0] for _ in range(4)]
    assert all(torch.equal(y, torch.full((2,), 5.0)) for y in ys)
    assert _delta(c0)[:4] == (4, 0, 0, 1) and sg.limit == 0
    assert "stream is capturing" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["i", "l"])
def test_encoder_through_graphs_equals_eager(eager_graph, mode):
    """PAL-I (VSB, FM, NICAM) and SECAM-L (SECAM chroma, AM, NICAM), six
    one-frame blocks streamed as the command line streams them: through
    the stand-in graphs (keys of period 2 from block 1: blocks 3 and 4
    capture, 5 replays) byte for byte the plain encoder's, the SECAM
    windows counted once a block and none by the card's kernel."""
    plain = Encoder(mode, 16_000_000, vfilter=True, device="cpu")
    graphed = Encoder(mode, 16_000_000, vfilter=True, device="cpu")
    assert plain._graphs is None and graphed._graphs is None
    graphed._graphs = step_graph.StepGraphs("cpu")
    c0 = telemetry.counters()
    w0 = c0.get("secam.windows", 0)
    k0 = c0.get("secam.kernel_windows", 0)
    pending, got = graphed.encode_block_device(0), []
    for b in range(1, 7):
        nxt = graphed.encode_block_device(b) if b < 6 else None
        got.append(graphed.collect_block(b - 1, pending))
        pending = nxt
    assert _delta(c0)[:4] == (5, 2, 1, 0)
    if mode == "l":
        assert telemetry.counters()["secam.windows"] - w0 == 6
    # the CPU runs the plain program, never the card's kernel
    assert telemetry.counters().get("secam.kernel_windows", 0) == k0
    for b, a in enumerate(got):
        assert a.tobytes() == plain.encode_block(b).tobytes(), b


def test_nicam_window_starts_uploaded_before_the_step():
    """nicam_add given the whole block's window starts (window_starts,
    uploaded with the block's arguments) equals nicam_add uploading them
    itself."""
    e = Encoder("i", 16_000_000, device="cpu")
    a = e._audio_args(3)
    nc = a["nicam"]
    si, sq = e._block_stage(e._device_rgb(3), a).nicam()
    out = torch.zeros(625, e.out_params.width)
    args = (e.nicam_statics, out, out, si, sq, nc["offq"], nc["offr"],
            nc["cc_off"], a["nicam_k0mod"])
    own = synth.nicam_add(*args)
    given = synth.nicam_add(*args, starts=nc["starts"])
    assert nc["starts"].dtype == torch.int64
    assert all(torch.equal(x, y) for x, y in zip(own, given, strict=True))
