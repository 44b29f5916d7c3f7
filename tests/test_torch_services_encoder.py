"""Encoders with the VBI services against hacktv_tpu on the CPU, byte for
byte: each service alone over one-frame blocks 0-1, on 625- and 525-line
modes where the service allows it (VITS also at 13.5 MS/s, blocks 0-2,
and at 13.5135 MS/s, where no exact carrier rows exist and it reads the
angle-addition carrier, blocks 0-3: the blocks where XLA's contraction
of the chroma mix shows);
everything at once; SiS at 16 MS/s over blocks 0-2; teletext and CEA-608
over two-frame blocks 0-2, where the halo lines of two blocks overlap;
the PAL-I chain with teletext, WSS, VITS and VITC through the VSB filter;
and the services' arrays carried over from the JAX encoder (convert.py)."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_common as tc
from _torch_vbi import ALONE, BLOCKS, COMBO, DEMO, check_blocks, encoders
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import convert


@pytest.mark.parametrize("name", sorted(ALONE))
def test_service_alone_matches_jax(name):
    mode, rate, kw = ALONE[name]
    j, t = encoders(mode, rate, kw)
    if name.endswith("-angle"):
        assert t.statics.carrier_rows is None
        assert t.statics.carrier_cos is not None
    check_blocks(name, j, t, range(BLOCKS.get(name, 2)))


@pytest.mark.parametrize("name", sorted(COMBO))
def test_services_together_match_jax(name):
    mode, rate, kw = COMBO[name]
    j, t = encoders(mode, rate, kw)
    check_blocks(name, j, t, range(2))


@pytest.mark.parametrize("name", ["pal-teletext", "ntsc-cc608",
                                  "pal-teletext-raw"])
def test_two_frame_blocks_match_jax(name):
    """Two-frame blocks 0-2: the teletext packet cache over the halo
    lines, the raw stream's reads and CEA-608's fifo carry across blocks
    as one-frame blocks do."""
    mode, rate, kw = ALONE[name]
    j, t = encoders(mode, rate, kw, fpb=2)
    check_blocks(f"{name} (2 frames)", j, t, range(3))


def test_pal_i_teletext_vsb_matches_jax():
    """chip_smoke.py's pal-i-teletext-vsb at one frame per block: the UK
    terrestrial signal, with FM and NICAM sound and the VSB filter."""
    j, t = encoders("i", 16_000_000, {"vfilter": True, "teletext": DEMO,
                                      "wss": "16:9", "vits": True,
                                      "vitc": True})
    check_blocks("pal-i-teletext-vsb", j, t, range(2))


def test_sis_pal_i_matches_jax():
    """SiS on PAL-I (chip_smoke.py's i-sis) with the VSB filter: the
    audio lag of the filter's window."""
    j, t = encoders("i", 16_000_000, {"sis": "dcsis", "vfilter": True})
    check_blocks("i-sis-vsb", j, t, range(3))


@pytest.mark.parametrize("name", ["pal-vits-wss-vitc-teletext",
                                  "ntsc-all"])
def test_service_statics_carry_over(name):
    """The services' arrays, read from the JAX encoder's service objects
    under convert.py's names, equal the port's; installed on a second port
    encoder they give the JAX encoder's bytes."""
    mode, rate, kw = COMBO[name]
    j, t = encoders(mode, rate, kw)
    arrays = convert.statics_to_numpy(t)
    want = {}
    for js, ts in zip(j.services, t.services):
        for f in ts.STATICS:
            want[convert.service_key(ts, f)] = np.asarray(getattr(js, f))
    assert len(want) >= 4
    tc.assert_same({k: arrays[k] for k in want}, want, "service statics")
    _, other = encoders(mode, rate, kw)
    convert.statics_from_numpy(other, {**arrays, **want})
    tc.assert_same(convert.statics_to_numpy(other), arrays, "installed")
    check_blocks(f"{name} (carried)", j, other, range(2))


def test_unknown_service_modes_raise():
    with pytest.raises(ValueError):
        TEncoder("pal", 16_000_000, wss="21:9", device="cpu")
    with pytest.raises(ValueError):
        TEncoder("pal", 16_000_000, sis="sis", device="cpu")
    with pytest.raises(ValueError):
        TEncoder("ntsc", 13_500_000, sis="dcsis", device="cpu")
