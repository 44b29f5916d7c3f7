"""Every mode the port accepts, against hacktv_tpu on the CPU, byte for
byte (part c of three; tests/_torch_modes.py has the lists and the
check)."""

from __future__ import annotations

import pytest

import _torch_modes as tm


@pytest.mark.parametrize("mode", tm.SWEEP_C)
def test_mode_matches_jax(mode):
    tm.check_mode(mode)
