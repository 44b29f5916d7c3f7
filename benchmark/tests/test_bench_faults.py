"""A run with the timed path broken underneath comes out not correct,
for each fault the cells can have (one card: no exchange between chips),
and the control (the reference in bfloat16 in the program's place) fails
the limits too.  Sound runs at the same size come out correct, also where
the program hands out one buffer that it writes again every block."""

import numpy as np
import pytest
import torch

from bench_common import run_small
from hacktv_tpu_torch import runtime
from hacktv_tpu_torch.encoder import Encoder

CELLS = ("pal-i-vsb.testcard", "pal-fm-preemph.testcard")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run_small(name)
    assert out["correct"], out["check"]
    assert all(v["value"] == 0 for v in out["check"].values())


def _altered(orig):
    def collect(self, b, dev):
        out = orig(self, b, dev).copy()
        out[len(out) // 3, 0] ^= 1          # one sample, one LSB
        return out
    return collect


def _half(orig):
    def collect(self, b, dev):
        out = orig(self, b, dev)
        return out[: len(out) // 2]         # half of the block left out
    return collect


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_altered, _half])
def test_broken_output_is_not_correct(monkeypatch, name, fault):
    monkeypatch.setattr(Encoder, "collect_block",
                        fault(Encoder.collect_block))
    assert not run_small(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_reused_output_buffer_is_correct(monkeypatch, name):
    # the samples of every block copied into one buffer, handed out again
    orig = Encoder.collect_block

    def collect(self, b, dev):
        out = orig(self, b, dev)
        buf = getattr(self, "_bench_buf", None)
        if buf is None or buf.shape != out.shape:
            buf = self._bench_buf = np.empty_like(out)
        buf[...] = out
        return buf
    monkeypatch.setattr(Encoder, "collect_block", collect)
    out = run_small(name, seconds=1.0)
    assert out["correct"], out["check"]


def _sink_half(orig):
    def write(self, iq):
        return orig(self, iq[: len(iq) // 2])   # half of each write
    return write


def _sink_altered(orig):
    def write(self, iq):
        iq = np.array(iq)
        iq[len(iq) // 3, 0] ^= 1
        return orig(self, iq)
    return write


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_sink_half, _sink_altered])
def test_broken_sink_is_not_correct(monkeypatch, name, fault):
    monkeypatch.setattr(runtime.NativeFileSink, "write",
                        fault(runtime.NativeFileSink.write))
    out = run_small(name)
    assert not out["correct"], out["check"]
    assert out["check"]["max_abs_diff"]["value"] > 0


def test_pal_i_state_unchanged_is_not_correct(monkeypatch):
    # the FM sound's phase anchor handed on unchanged from block to block
    orig = Encoder._take_carry

    def take(self, b, carry):
        carry = dict(carry, fm_xa=self._fm_xa[b][1])
        return orig(self, b, carry)
    monkeypatch.setattr(Encoder, "_take_carry", take)
    assert not run_small("pal-i-vsb.testcard")["correct"]


def test_pal_fm_state_unchanged_is_not_correct(monkeypatch):
    # the FM-video recurrence's phase left as it was before the block
    orig = Encoder.collect_block

    def collect(self, b, dev):
        fx = self.fm_video_exact
        keep = fx._state.copy()
        out = orig(self, b, dev)
        fx._state[:] = keep
        return out
    monkeypatch.setattr(Encoder, "collect_block", collect)
    out = run_small("pal-fm-preemph.testcard")
    assert not out["correct"] and out["check"]["state_gap"]["value"] > 0


def test_pal_fm_state_reset_between_blocks_is_not_correct(monkeypatch):
    # the FM-video recurrence started afresh at every block: each block
    # follows from its own start state, and only the chain is broken
    orig = Encoder.collect_block

    def collect(self, b, dev):
        self.fm_video_exact._state[:] = [2147483647, 0, 32767]
        return orig(self, b, dev)
    monkeypatch.setattr(Encoder, "collect_block", collect)
    out = run_small("pal-fm-preemph.testcard")
    assert not out["correct"] and out["check"]["state_gap"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = run_small(name, control_dtype=torch.bfloat16)
    assert not out["correct"], out["check"]
    assert out["check"]["max_abs_diff"]["value"] > 0
    assert np.isfinite(out["check"]["max_abs_diff"]["value"])
