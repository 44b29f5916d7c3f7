"""Encoders with Nagravision Syster, Syster cut-and-rotate, Discret 11 and
the Syster audio inversion against hacktv_tpu on the CPU, byte for byte,
over one-frame blocks 0-2: PAL with Syster; SECAM-L with Syster, the
inverted sound and the VSB filter (Canal+ France), blocks 0-3, where the
345-line bottom halo, SECAM's IIR carry and the filter's stream cross
every boundary; PAL with cut-and-rotate alone and with Syster; SECAM-L
with Discret 11; PAL-I with SiS and the inverted sound; the scramblers'
arrays carried over (convert.py); and the JAX package's refusals."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_common as tc
from _torch_scramble import (BLOCKS, RATE, SYSTER, check_blocks,
                             encoders)
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import convert


@pytest.mark.parametrize("name", sorted(SYSTER))
def test_syster_matches_jax(name):
    mode, kw = SYSTER[name]
    j, t = encoders(mode, kw)
    check_blocks(name, j, t, range(BLOCKS.get(name, 3)))


def test_syster_halo_and_ring():
    """Syster reads 344 lines ahead and holds 345 lines of the output
    ring: the bottom halo and the first block's sync spill follow."""
    _, t = encoders("pal", SYSTER["pal-syster"][1])
    assert t.halo_after == 344
    assert t._spill_warmup > 345


@pytest.mark.parametrize("name", ["pal-syster-systercnr", "l-d11",
                                  "pal-systercnr"])
def test_syster_statics_carry_over(name):
    """Syster's basis, the cut-and-rotate column table and sequence, and
    Discret 11's delay table, from the JAX encoder under convert.py's
    names: installed on a port encoder they give the JAX bytes."""
    mode, kw = SYSTER[name]
    j, t = encoders(mode, kw)
    arrays = convert.statics_to_numpy(t)
    want = {}
    for js, ts in zip(j.services, t.services):
        for f in ts.STATICS:
            want[convert.service_key(ts, f)] = np.asarray(getattr(js, f))
    assert len(want) >= 2
    tc.assert_same({k: arrays[k] for k in want}, want, "syster statics")
    _, other = encoders(mode, kw)
    convert.statics_from_numpy(other, {**arrays, **want})
    tc.assert_same(convert.statics_to_numpy(other), arrays, "installed")
    check_blocks(f"{name} (carried)", j, other, range(2))


@pytest.mark.parametrize("mode,kw", [
    ("m", {"syster": "premiere-fa"}),
    ("pal", {"syster": "free"}),
    ("pal", {"systercnr": "canal"}),
    ("ntsc", {"d11": "premiere-fa"}),
])
def test_syster_refusals_match_jax(mode, kw):
    """A 525-line mode or an unknown Syster mode: the JAX package's
    ValueError and message."""
    from hacktv_tpu import Encoder as JEncoder
    msgs = []
    for make in (lambda: JEncoder(mode, RATE, **kw),
                 lambda: TEncoder(mode, RATE, device="cpu", **kw)):
        with pytest.raises(ValueError) as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
