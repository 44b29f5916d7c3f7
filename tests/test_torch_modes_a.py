"""Every mode the port accepts, against hacktv_tpu on the CPU, byte for
byte (part a of three; tests/_torch_modes.py has the lists and the
check)."""

from __future__ import annotations

import pytest

import _torch_modes as tm


@pytest.mark.parametrize("mode", tm.SWEEP_A)
def test_mode_matches_jax(mode):
    tm.check_mode(mode)


def test_sweep_covers_every_accepted_mode():
    """The registry's 50 modes all run in the port: 44 through Encoder
    (each held by one of the sweep files or by another test file;
    ntsc-bs by tests/test_torch_dance.py), and the six MAC modes through
    video/mac.py's MacEncoder (tests/test_torch_mac_encoder_*.py), which
    create_encoder picks for them; Encoder refuses them with
    ValueError."""
    from hacktv_tpu_torch import Encoder, create_encoder
    from hacktv_tpu_torch.config.standards import REGISTRY
    from hacktv_tpu_torch.video.mac import MacEncoder
    swept = tm.SWEEP_A + tm.SWEEP_B + tm.SWEEP_C
    held = swept + tm.HELD_ELSEWHERE
    assert len(held) == len(set(held)) == 44
    assert sorted(held + tm.MAC) == sorted(REGISTRY)
    for mode in tm.MAC:
        with pytest.raises(ValueError, match="MacEncoder"):
            Encoder(mode, 20_250_000, device="cpu")
        enc = create_encoder(mode, 20_250_000, device="cpu")
        assert isinstance(enc, MacEncoder)
