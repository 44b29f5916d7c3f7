"""D/D2-MAC encoders (video/mac.py MacEncoder, on the CPU) against
hacktv_tpu, byte for byte over one-frame blocks 0-2: the six MAC modes
(baseband, AM and FM, D2-MAC and D-MAC), the single and double cut and
scrambled audio, and the port's plain Python multiplex on the host-bits
step."""

from __future__ import annotations

import pytest

from _torch_mac import check_blocks, encoders

MODES = ["d2mac", "d2mac-am", "d2mac-fm", "dmac", "dmac-am", "dmac-fm"]


@pytest.mark.parametrize("mode", MODES)
def test_mac_mode_matches_jax(mode):
    j, t = encoders(mode)
    assert t.device_mat and t.width == j.width == 1296
    check_blocks(mode, j, t, range(3))


@pytest.mark.parametrize("mode,kw", [
    ("d2mac", {"scramble_video": 1}),
    ("dmac", {"scramble_video": 2}),
    ("d2mac", {"scramble_audio": True}),
    ("dmac-fm", {"scramble_video": 2, "scramble_audio": True}),
], ids=["d2mac-single-cut", "dmac-double-cut", "d2mac-scramble-audio",
        "dmac-fm-double-cut-audio"])
def test_mac_scrambling_matches_jax(mode, kw):
    j, t = encoders(mode, kw)
    assert t.vsam == j.vsam
    check_blocks(f"{mode} {kw}", j, t, range(3))


@pytest.mark.parametrize("mode,kw", [
    ("d2mac", {}),
    ("dmac", {"scramble_video": 2, "scramble_audio": True}),
], ids=["d2mac", "dmac-double-cut-audio"])
def test_python_multiplex_matches_jax(mode, kw):
    """native=False: the plain Python multiplex and the host-bits step
    (packed line bits uploaded) give the JAX encoder's bytes."""
    j, t = encoders(mode, kw, native=False)
    assert not t.device_mat and not t.mux.native
    check_blocks(f"{mode} python", j, t, range(3))
