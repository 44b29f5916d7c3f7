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
    """The registry's 50 modes: 44 run in the port (each held by one of
    the sweep files or by another test file; ntsc-bs by
    tests/test_torch_dance.py), and only the six MAC modes still raise
    NotImplementedError."""
    from hacktv_tpu_torch import Encoder
    from hacktv_tpu_torch.config.standards import REGISTRY
    swept = tm.SWEEP_A + tm.SWEEP_B + tm.SWEEP_C
    held = swept + tm.HELD_ELSEWHERE
    assert len(held) == len(set(held)) == 44
    assert sorted(held + tm.REFUSED) == sorted(REGISTRY)
    for mode in tm.REFUSED:
        with pytest.raises(NotImplementedError):
            Encoder(mode, 20_250_000, device="cpu")
