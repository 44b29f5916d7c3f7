"""Encoder(devices=...) and MacEncoder(devices=...) on the CPU: the
configurations of __graft_entry__.dryrun_multichip (PAL-I and NTSC-M
with --filter at 1 MS/s, SECAM-L, Syster, D2-MAC), in 2 and 4 shards,
byte for byte hacktv_tpu's single-device encoder and the port's own;
PAL-I in 2 shards against hacktv_tpu's own sharded encoder; and the
refusal of a block that does not divide over the devices."""

from __future__ import annotations

import jax
import numpy as np
import pytest

import _torch_common as tc
import _torch_devices as td
from hacktv_tpu import Encoder as JEncoder


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["i", "m-vsb", "l", "i-syster", "d2mac"])
def test_sharded_matches_jax(name, n):
    td.check(name, n)


def test_pal_i_matches_jax_sharded():
    """PAL-I in 2 shards against hacktv_tpu's Encoder on a 2-device mesh
    (GSPMD's partition of the same block)."""
    tc.jax_runtime()
    j = JEncoder("i", 1_000_000, frames_per_block=8, fm_direct_trig=True,
                 devices=jax.devices()[:2])
    t = td.make("i", devices=["cpu", "cpu"])
    for b in (0, 1):
        ref = np.asarray(j.encode_block(b))
        _, mx, nd = tc.error_report(t.encode_block(b), ref)
        assert nd == 0, f"block {b}: {nd} samples differ (max {mx})"


@pytest.mark.parametrize("name", ["i", "d2mac"])
def test_indivisible_lines_refused(name):
    """hacktv_tpu's ValueError when a block's lines do not divide over
    the devices (8 frames of 625 lines over 3)."""
    with pytest.raises(ValueError, match="block of 5000 lines does not "
                       "divide over 3 devices; adjust frames_per_block"):
        td.make(name, devices=["cpu"] * 3)
