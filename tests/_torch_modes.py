"""The sweep of every registry mode the port accepts against hacktv_tpu
(tests/test_torch_modes_*.py): the test card, one-frame blocks 0-1, at
tests/test_all_modes.py's rates, byte for byte.  Three files share the
modes so that a run with `--dist loadfile` spreads them over workers; the
slowest two (ntsc-i and pal60-i, with NICAM at 13.5 MS/s) sit in
different files."""

from __future__ import annotations

import numpy as np

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch.config import get_mode

# tests/test_all_modes.py's rate for each line count
RATES = {30: 100_000, 32: 100_000, 240: 2_000_000, 320: 2_000_000,
         405: 4_000_000, 525: 13_500_000, 625: 4_000_000,
         819: 20_000_000}

SWEEP_A = ["ntsc-i", "b", "pal-d", "30", "30-am", "nbtv", "nbtv-am",
           "apollo-fsc", "apollo-fsc-fm", "cbs405", "m-cbs405"]
SWEEP_B = ["pal60-i", "pal-m", "pal-n", "525pal", "ntsc", "pal60"]
SWEEP_C = ["pal-k", "k", "secam-b", "secam-g", "secam-i", "e", "819",
           "ntsc-a", "405", "405-i", "ntsc-405", "240", "240-am", "apollo",
           "apollo-fm"]
# accepted modes held by other files at their own rates
HELD_ELSEWHERE = ["i", "g", "pal", "m", "secam", "l", "d", "a", "pal-fm",
                  "ntsc-fm", "secam-fm", "ntsc-bs"]
# the D/D2-MAC modes: video/mac.py's MacEncoder, held by
# tests/test_torch_mac_encoder_*.py (Encoder refuses them)
MAC = ["d2mac-fm", "d2mac-am", "d2mac", "dmac-fm", "dmac-am", "dmac"]
BLOCKS = 2


def check_mode(mode: str) -> None:
    """Blocks 0-1 of the mode's test card, port against hacktv_tpu."""
    rate = RATES[get_mode(mode).lines]
    j = JEncoder(mode, rate)
    t = TEncoder(mode, rate, device="cpu")
    for b in range(BLOCKS):
        ref, got = j.encode_block(b), t.encode_block(b)
        assert got.shape == ref.shape and got.dtype == ref.dtype, \
            f"{mode} block {b}: {got.shape} {got.dtype} != " \
            f"{ref.shape} {ref.dtype}"
        snr, maxerr, ndiff = tc.error_report(got, ref)
        assert ndiff == 0, (f"{mode} at {rate} S/s, block {b}: {ndiff} of "
                            f"{ref.size} samples differ, max {maxerr}, "
                            f"{snr:.1f} dB")
        assert np.abs(got.astype(np.int64)).max() > 0
