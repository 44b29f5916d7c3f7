"""The D/D2-MAC packet multiplex (video/mac.py MacMux) against hacktv_tpu,
byte for byte over ten frames: the packed line bits and start polarities
(MacMux.bits_block, line_bits), the device-assembly bundle
(device_bits_block), the single- and double-cut arrays (scramble_block)
with scrambled audio, line 625 batched against one at a time; and the
port's plain Python replay (`native=False`) against its native one."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_common as tc
from _torch_mac import check_mux, muxes

FRAMES = 10


@pytest.mark.parametrize("mode", ["d2mac", "dmac"])
def test_mux_line_bits_match_jax(mode):
    j, t = muxes(mode)
    check_mux(mode, j, t, FRAMES)
    # the per-line view over the last window, where the tests read it
    for k in range(FRAMES * 625 - 700, FRAMES * 625 - 1, 37):
        tc.assert_same(t.line_bits[k], j.line_bits[k], f"line {k}")
        assert t.pol_start[k] == j.pol_start[k]


@pytest.mark.parametrize("mode", ["d2mac", "dmac"])
def test_mux_device_bundle_matches_jax(mode):
    """device_bits_block's upload bundle (stream slices, per-row lengths,
    positions, the packed 624/625 rows) as MacEncoder's main path takes
    it, over one-frame windows with their boundary rows."""
    j, t = muxes(mode)
    j.device_mode = t.device_mode = True
    n = 625
    for b in range(FRAMES):
        k0 = b * n
        j.ensure(k0 + n)
        t.ensure(k0 + n)
        tc.assert_same(t.device_bits_block(k0 - 1, k0 + n + 1),
                       j.device_bits_block(k0 - 1, k0 + n + 1),
                       f"{mode} window {b}")
        tc.assert_same(t.scramble_block(k0, k0 + n),
                       j.scramble_block(k0, k0 + n), f"{mode} window {b}")
        j.prune(k0 + n - 2)
        t.prune(k0 + n - 2)


@pytest.mark.parametrize("mode,vsam", [("d2mac", 2), ("dmac", 0),
                                       ("d2mac", 0)],
                         ids=["d2mac-single-cut", "dmac-double-cut",
                              "d2mac-double-cut"])
def test_mux_cuts_match_jax(mode, vsam):
    """Single cut (vsam 2) and double cut (vsam 0) in free access with
    scrambled audio: the PRBS2 cut points per line and the scrambled
    audio packets."""
    j, t = muxes(mode, vsam=vsam, scramble_audio=True)
    check_mux(f"{mode} vsam {vsam}", j, t, FRAMES)
    ap, x1, x2 = t.scramble_block(625, 2 * 625)
    assert ap.any() and (x1 != 282).any()
    if vsam == 0:
        assert (x2 != 682).any()


@pytest.mark.parametrize("mode,kw", [
    ("d2mac", {}),
    ("dmac", {"vsam": 0, "scramble_audio": True}),
    ("d2mac", {"vsam": 2, "provider": "ctv"}),
], ids=["d2mac", "dmac-double-cut-audio", "d2mac-ctv"])
def test_python_replay_matches_native(mode, kw):
    """The port's plain Python multiplex (queue replay, line-bit
    assembly, PRBS recurrences, packet and audio coders) against its
    native one, and both against the JAX package, over ten frames."""
    j, t = muxes(mode, **kw)
    _, p = muxes(mode, native=False, **kw)
    assert p.prbs1.native is False and p.audio.native is False
    step = 5 * 625
    for hi in range(step, FRAMES * 625 + 1, step):
        for m in (j, t, p):
            m.ensure(hi)
        ref = j.bits_block(hi - step, hi)
        tc.assert_same(t.bits_block(hi - step, hi), ref, f"native {hi}")
        tc.assert_same(p.bits_block(hi - step, hi), ref, f"python {hi}")
        tc.assert_same(p.scramble_block(hi - step, hi),
                       t.scramble_block(hi - step, hi), f"scramble {hi}")
        assert p.queues == t.queues and p.cw == t.cw
        for m in (j, t, p):
            m.prune(hi - 1)


@pytest.mark.parametrize("mode", ["d2mac", "dmac"])
def test_line_625_batch_matches_single(mode):
    """_lines_625_batch, the window's frame-sync rows in one pass, equals
    _line_625 frame by frame (on two multiplexes in the same state)."""
    _, a = muxes(mode)
    _, b = muxes(mode)
    frames = np.arange(1, 12)
    rows = a._lines_625_batch(frames)
    for i, f in enumerate(frames):
        tc.assert_same(rows[i], b._line_625(int(f), 625), f"frame {f}")


def test_mux_stream_continues_across_unaligned_windows():
    """Windows that end mid-frame (ensure through arbitrary lines) give
    the same line bits as frame-aligned ones."""
    j, t = muxes("d2mac", vsam=2)
    for hi in (301, 950, 2000, 3125, 4000):
        j.ensure(hi)
        t.ensure(hi)
        lo = hi - 250
        tc.assert_same(t.bits_block(lo, hi), j.bits_block(lo, hi), str(hi))
        tc.assert_same(t.scramble_block(lo, hi), j.scramble_block(lo, hi),
                       str(hi))
