"""A configuration may name the serial host states that its reference
takes from the program at a drawn block's start (`check.follows`).  The
harness reads each before and after the call that advances it, checks the
chain block by block as the stream goes by, holds whole states only for
the blocks the reservoir holds and the block in flight, and refuses by
name, before the warm-up, a follow that the encoder lacks or whose state
is a torch.Tensor.

Run on the CPU with a fake serial encoder and a fake reference: every
block depends on a running parity over all the blocks before it, as
MAC's duobinary polarity does, and on a multiplex of 1,500 integers that
the dispatch advances.  The listed cells name no follow and report no
`state_gap`; on pal-fm-preemph's FM carriers (the follows an encoder
gets when its file names none) the chain checked block by block counts
what a check over the whole record counts."""

import sys
import types

import numpy as np
import pytest
import torch

from bench_common import SEED, run_small, small_cell
from harness import check, loop
from harness.manifest import load_manifest
import run

CPU = torch.device("cpu")
LISTED = [w["name"] for w in load_manifest()["workloads"]]
STATE = 1500            # integers of the fake multiplex's state
LEN = 256               # samples a block
K = 2                   # blocks the reservoir draws
TICK = 1e-3             # the fake clock's seconds a block
M = 2**31 - 1


def initial_mux() -> np.ndarray:
    return np.arange(STATE, dtype=np.int64) * 7919 % M


def advance(mux: np.ndarray, b: int) -> np.ndarray:
    """The multiplex after block b: a Lehmer step of every word."""
    return (mux * 48271 + b + 1) % M


def render(mux: np.ndarray, pol: int, b: int) -> tuple:
    """Block b's samples from the multiplex at its dispatch and the
    parity `pol` at its start, which flips on every 0 bit; and the
    parity at its end."""
    bits = (mux[:LEN] >> (b % 7)) & 1
    flips = np.cumsum(bits == 0)
    p = (pol + flips) & 1
    out = np.where(p == 1, 8000, -8000) + mux[:LEN] % 1000
    return out.astype(np.int16), int((pol + flips[-1]) & 1)


class Holder:
    def __init__(self, state):
        self._state, self.n = state, 0


class Clock:
    """A host clock that the fake encoder moves a tick a block."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        return self.t


class SerialEncoder:
    """The fake program: `mux` advances at the dispatch, `pol` at the
    collect; real output."""

    complex_out = False

    def __init__(self, clock: Clock):
        self.clock = clock
        self.mux = Holder(initial_mux())
        self.pol = Holder([0])
        self.dispatched = 0

    def encode_block_device(self, b: int):
        start = self.mux._state
        self.mux._state = advance(start, b)
        self.mux.n += 1
        self.dispatched += 1
        return start

    def collect_block(self, b: int, start):
        out, end = render(start, self.pol._state[0], b)
        self.pol._state = [end]
        self.pol.n += LEN
        self.clock.t += TICK
        return out


class SerialReference:
    """The fake plain reference: block b from the followed states at its
    start."""

    def initial_states(self) -> dict:
        return {"mux": (tuple(initial_mux().tolist()), 0), "pol": ((0,), 0)}

    def encode_block(self, b: int, start: dict):
        mux, n = start["mux"]
        (pol,), pn = start["pol"]
        mux = np.array(mux, np.int64)
        out, end = render(mux, pol, b)
        return out, {"mux": (tuple(advance(mux, b).tolist()), n + 1),
                     "pol": ((end,), pn + LEN)}


FOLLOWS = {"mux": ["mux", "dispatch"], "pol": ["pol", "collect"]}


def serial_cell(follows=FOLLOWS) -> dict:
    config = {"name": "serial", "reference": "bench_test_serial",
              "check": {"blocks": K, "follows": follows,
                        "limits": {"max_abs_diff": 0, "state_gap": 0}}}
    return {"workload": {"name": "serial.fake", "chips": 1},
            "config": config,
            "mix": {"frames_per_block": 1, "warmup_blocks": 3},
            "end_to_end": [{"name": "samples_per_s", "unit": "samples/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": []}


@pytest.fixture
def serial(monkeypatch):
    """run(blocks, cell=None) runs run_cell on the fake encoder for about
    `blocks` blocks of the window; `.enc` is the encoder it built."""
    clock = Clock()
    monkeypatch.setattr(loop, "time", clock)
    ref = types.ModuleType("reference.bench_test_serial")
    ref.make = lambda *a, **k: SerialReference()
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    made = types.SimpleNamespace(enc=None)

    def build(config, mix, seed, device):
        made.enc = SerialEncoder(clock)
        return made.enc, None
    monkeypatch.setattr(run, "build", build)

    def go(blocks: int, cell=None) -> dict:
        return run.run_cell(cell or serial_cell(), SEED,
                            (blocks - 0.5) * TICK, False, device="cpu",
                            t_start=0.0)
    made.run = go
    return made


def test_correct_program_is_correct(serial):
    out = serial.run(400)
    assert out["attempted"] == 400
    assert out["correct"], out["check"]
    assert {k: v["value"] for k, v in out["check"].items()} == \
        {"max_abs_diff": 0, "state_gap": 0}


def test_state_update_skipped_between_undrawn_blocks(serial, monkeypatch):
    # block 201's dispatch update lost at block 200's collect, which runs
    # between block 201's dispatch and block 202's: neither is drawn
    snaps = {}
    dispatch, collect = (SerialEncoder.encode_block_device,
                         SerialEncoder.collect_block)

    def snap(self, b):
        snaps[b] = self.mux._state
        return dispatch(self, b)

    def lose(self, b, start):
        if b == 200:
            self.mux._state = snaps[201]
        return collect(self, b, start)
    monkeypatch.setattr(SerialEncoder, "encode_block_device", snap)
    monkeypatch.setattr(SerialEncoder, "collect_block", lose)
    out = serial.run(400)
    assert not {200, 201, 202} & set(out["_blocks_checked"])
    assert out["check"]["max_abs_diff"]["value"] == 0
    assert out["check"]["state_gap"]["value"] > 0
    assert not out["correct"]


def test_wrong_sample_in_a_drawn_block(serial, monkeypatch):
    # one sample of every block altered, every state as it should be
    collect = SerialEncoder.collect_block

    def altered(self, b, start):
        out = collect(self, b, start).copy()
        out[LEN // 3] ^= 1
        return out
    monkeypatch.setattr(SerialEncoder, "collect_block", altered)
    out = serial.run(400)
    assert out["check"]["max_abs_diff"]["value"] > 0
    assert out["check"]["state_gap"]["value"] == 0
    assert not out["correct"]


def test_end_state_the_output_does_not_follow(serial, monkeypatch):
    # every dispatch leaves one word of the multiplex off by one: the
    # chain holds and every block follows from its start, but no end is
    # what the block's start makes
    dispatch = SerialEncoder.encode_block_device

    def skewed(self, b):
        dev = dispatch(self, b)
        self.mux._state = self.mux._state.copy()
        self.mux._state[7] += 1
        return dev
    monkeypatch.setattr(SerialEncoder, "encode_block_device", skewed)
    out = serial.run(400)
    assert out["check"]["max_abs_diff"]["value"] == 0
    assert out["check"]["state_gap"]["value"] == K     # one word a block
    assert not out["correct"]


@pytest.mark.parametrize("follows,named", [
    ({**FOLLOWS, "queue": ["mux_queue", "dispatch"]}, "'queue'.*mux_queue"),
    ({"mux": ["mux", "write"]}, r"'mux'.*dispatch \| collect"),
], ids=["missing", "no-such-call"])
def test_missing_follow_is_refused_by_name(serial, follows, named):
    with pytest.raises(ValueError, match=named):
        serial.run(10, serial_cell(follows))
    assert serial.enc.dispatched == 0       # before the warm-up


@pytest.mark.parametrize("tensor", [
    lambda enc: setattr(enc.mux, "_state", torch.as_tensor(initial_mux())),
    lambda enc: setattr(enc.pol, "_state", [torch.zeros((), dtype=torch.int64)]),
    lambda enc: setattr(enc.pol, "n", torch.zeros((), dtype=torch.int64)),
], ids=["state", "held-in-a-list", "n"])
def test_tensor_state_is_refused_by_name(serial, monkeypatch, tensor):
    init = SerialEncoder.__init__

    def on_tensors(self, clock):
        init(self, clock)
        tensor(self)
    monkeypatch.setattr(SerialEncoder, "__init__", on_tensors)
    with pytest.raises(ValueError, match="follow '(mux|pol)'.*torch.Tensor"):
        serial.run(10)
    assert serial.enc.dispatched == 0


def test_held_states_are_bounded_by_the_reservoir(serial, monkeypatch):
    held = []
    keep = check.Chain.keep

    def counted(self, blocks, b):
        keep(self, blocks, b)
        held.append(len({blk for _, blk in (*self.recent, *self.kept)}))
        assert len(self.first) == len(FOLLOWS)  # block 0's starts
    monkeypatch.setattr(check.Chain, "keep", counted)
    out = serial.run(5200)
    assert out["attempted"] == len(held) == 5200
    assert max(held) <= K + 1                   # the drawn and the in-flight
    assert out["correct"], out["check"]
    assert out["check"]["state_gap"]["value"] == 0


def test_read_states_are_host_integers():
    enc = types.SimpleNamespace(
        a=Holder(np.array([[1, 2], [3, 4]], np.int32)),
        b=Holder([np.int64(5), 6, True]))
    chain = check.Chain({"a": ["a", "dispatch"], "b": ["b", "collect"]}, enc)
    assert chain.read(enc, "dispatch") == {"a": ((1, 2, 3, 4), 0)}
    got = chain.read(enc, "collect")["b"]
    assert got == ((5, 6, 1), 0)
    assert all(type(v) is int for v in got[0])


# -- the listed cells and pal-fm's FM carriers ---------------------------

@pytest.mark.parametrize("name", LISTED)
def test_listed_cells_build_no_follow(name):
    c = small_cell(name)
    enc, _ = run.build(c["config"], c["mix"], SEED, CPU)
    assert run.follows(c["config"], enc) == {}


@pytest.mark.parametrize("name", LISTED)
def test_listed_cells_report_no_state_gap(name):
    out = run_small(name)
    assert list(out["check"]) == ["max_abs_diff"]
    assert out["correct"], out["check"]


def continuity_gap(states: dict, initial: dict) -> int:
    """The rule over the whole record ((name, block) -> (start, end) of
    every block read): components of a block's start that differ from
    the end of the block before it (block 0's from `initial`); a block
    whose predecessor is missing counts every component."""
    gap = 0
    for (n, b), (start, _) in states.items():
        if b == 0:
            gap += check._differ(start, initial[n])
        elif (n, b - 1) in states:
            gap += check._differ(start, states[(n, b - 1)][1])
        else:
            gap += len(check._components(start))
    return gap


def _fm_unchanged(monkeypatch):
    from hacktv_tpu_torch.encoder import Encoder
    orig = Encoder.collect_block

    def collect(self, b, dev):
        fx = self.fm_video_exact
        keep = fx._state.copy()
        out = orig(self, b, dev)
        fx._state[:] = keep
        return out
    monkeypatch.setattr(Encoder, "collect_block", collect)


def _fm_reset(monkeypatch):
    from hacktv_tpu_torch.encoder import Encoder
    orig = Encoder.collect_block

    def collect(self, b, dev):
        self.fm_video_exact._state[:] = [2147483647, 0, 32767]
        return orig(self, b, dev)
    monkeypatch.setattr(Encoder, "collect_block", collect)


def _fm_reset_at_dispatch(monkeypatch):
    # the FM-video recurrence started afresh outside its own call: the
    # chain breaks at every block
    from hacktv_tpu_torch.encoder import Encoder
    orig = Encoder.encode_block_device

    def dispatch(self, b):
        self.fm_video_exact._state[:] = [2147483647, 0, 32767]
        return orig(self, b)
    monkeypatch.setattr(Encoder, "encode_block_device", dispatch)


@pytest.mark.parametrize("fault", [None, _fm_unchanged, _fm_reset,
                                   _fm_reset_at_dispatch],
                         ids=["sound", "state-unchanged", "reset",
                              "reset-at-dispatch"])
def test_chain_counts_what_the_whole_record_does(monkeypatch, fault):
    record, seen = {}, {}
    link, compare = check.Chain._link, check.compare

    def recorded(self, name, b, start, end):
        record[(name, b)] = (start, end)
        return link(self, name, b, start, end)

    def both(kept, chain, reference, **kw):
        init = reference.initial_states()
        seen["chain"] = chain.gap + chain.initial_gap(init)
        seen["whole"] = continuity_gap(record, init)
        return compare(kept, chain, reference, **kw)
    monkeypatch.setattr(check.Chain, "_link", recorded)
    monkeypatch.setattr(check, "compare", both)
    if fault is not None:
        fault(monkeypatch)
    out = run_small("pal-fm-preemph.testcard")
    assert {n for n, _ in record} == {"fm_sound", "fm_video"}
    assert seen["chain"] == seen["whole"]
    assert (seen["whole"] > 0) == (fault is _fm_reset_at_dispatch)
    assert out["correct"] == (fault is None)
