"""The plain reference against the port's CPU path at one frame a block,
for both configurations: the reference computes each block on its own
(pal-i-vsb seeks to it), the port streams them in order."""

import numpy as np
import pytest
import torch

from bench_common import SEED, small_cell
import run


def _port_blocks(c, blocks):
    enc, _ = run.build(c["config"], c["mix"], SEED, torch.device("cpu"))
    return [enc.encode_block(b) for b in range(blocks)]


def test_pal_i_reference_seeks_to_each_block():
    c = small_cell("pal-i-vsb.testcard")
    want = _port_blocks(c, 4)
    ref = run.reference(c["config"], c["mix"], SEED, "cpu")
    for b in (3, 0, 2):
        got, _ = ref.encode_block(b)
        np.testing.assert_array_equal(got, want[b])


def test_pal_fm_reference_follows_the_recurrences():
    c = small_cell("pal-fm-preemph.testcard")
    want = _port_blocks(c, 3)
    ref = run.reference(c["config"], c["mix"], SEED, "cpu")
    states = ref.initial_states()
    for b in range(3):
        got, states = ref.encode_block(b, states)
        np.testing.assert_array_equal(got, want[b])
    assert states["fm_video"][1] == 3 * 625 * 1296


def test_reference_refuses_what_it_does_not_run():
    from reference.codec.encoder import Encoder
    for mode in ("secam", "ntsc-bs", "a"):
        with pytest.raises(NotImplementedError):
            Encoder(mode, 16_000_000, device="cpu")
