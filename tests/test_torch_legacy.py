"""The legacy raster modes against hacktv_tpu on the CPU: the rotated
frames of Baird 30 and NBTV (`_OrientedSource`, av/frame_ops.py) and
field-sequential colour (Apollo, CBS 405: one grey plane per B/G/R field,
the flag pulses, the field channel in the metadata cache key).  Encoders
are byte-identical over one-frame blocks 0-3, which cover all three
colour fields and each mode's second block, and over two-frame blocks;
the frame ops, the FSC raster statics and synth_block equal the JAX
package's."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu import encoder as jencoder
from hacktv_tpu.av import frame_ops as jframe_ops
from hacktv_tpu.av.testcard import TestCardSource as JTestCard
from hacktv_tpu.config import get_mode as jget_mode
from hacktv_tpu.video import params as jparams
from hacktv_tpu.video import raster as jraster
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import encoder as tencoder
from hacktv_tpu_torch.av import frame_ops as tframe_ops
from hacktv_tpu_torch.av.testcard import TestCardSource as TTestCard
from hacktv_tpu_torch.config import get_mode as tget_mode
from hacktv_tpu_torch.video import params as tparams
from hacktv_tpu_torch.video import raster as traster

# mode: sample rate (the rates chip_smoke.py runs them at)
MODES = {"30": 100_000, "30-am": 100_000, "nbtv": 100_000,
         "nbtv-am": 100_000, "apollo-fsc": 14_000_000,
         "apollo-fsc-fm": 13_500_000, "cbs405": 9_000_000,
         "m-cbs405": 14_000_000}
BLOCKS = 4


def _check(name, got, ref, block):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    snr, maxerr, ndiff = tc.error_report(got, ref)
    assert ndiff == 0, (f"{name} block {block}: {ndiff} of {ref.size} "
                        f"samples differ, max {maxerr}, {snr:.1f} dB")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_encoder_matches_jax(mode):
    rate = MODES[mode]
    j = JEncoder(mode, rate)
    t = TEncoder(mode, rate, device="cpu")
    assert (t.source.width, t.source.height) == (j.source.width,
                                                 j.source.height)
    for b in range(BLOCKS):
        _check(mode, t.encode_block(b), j.encode_block(b), b)


@pytest.mark.parametrize("mode", ["30-am", "apollo-fsc", "cbs405"])
def test_two_frame_blocks_match_jax(mode):
    rate = MODES[mode]
    j = JEncoder(mode, rate, frames_per_block=2)
    t = TEncoder(mode, rate, frames_per_block=2, device="cpu")
    for b in range(2):
        _check(f"{mode} (2 frames)", t.encode_block(b), j.encode_block(b), b)


def test_fsc_block_out_of_order_matches_jax():
    """Block 3 of apollo-fsc shares block 1's line parity and carrier
    terms and only the colour field tells their metadata apart: encoded
    after block 1 it must not take block 1's cached metadata."""
    rate = MODES["apollo-fsc"]
    j = JEncoder("apollo-fsc", rate)
    t = TEncoder("apollo-fsc", rate, device="cpu")
    for b in (1, 3):
        _check("apollo-fsc", t.encode_block(b), j.encode_block(b), b)


@pytest.mark.parametrize("a", range(4))
def test_frame_ops_match_jax(a):
    rgb = np.random.default_rng(a).integers(0, 256, (5, 7, 3),
                                            dtype=np.uint8)
    for name, args in (("rotate", (rgb, a)), ("hflip", (rgb,)),
                       ("vflip", (rgb,))):
        got = getattr(tframe_ops, name)(*args)
        ref = getattr(jframe_ops, name)(*args)
        tc.assert_same(np.ascontiguousarray(got), np.ascontiguousarray(ref),
                       name)


@pytest.mark.parametrize("orientation", range(16))
def test_oriented_source_matches_jax(orientation):
    t = tencoder._OrientedSource(TTestCard(64, 40), orientation)
    j = jencoder._OrientedSource(JTestCard(64, 40), orientation)
    assert (t.width, t.height, t.stateless) == (j.width, j.height,
                                                j.stateless)
    tc.assert_same(t.read_video(0), j.read_video(0), "frame")
    tc.assert_same(t.read_audio(100, 50), j.read_audio(100, 50), "audio")


@functools.lru_cache(maxsize=None)
def _fsc_setup(mode):
    rate = MODES[mode]
    tp = tparams.VideoParams.create(tget_mode(mode), rate, 0)
    jp = jparams.VideoParams.create(jget_mode(mode), rate, 0)
    w = tp.active_width
    return tp, jp, traster.make_statics(tp, 0, w), \
        jraster.make_statics(jp, 0, w)


@pytest.mark.parametrize("mode", ["apollo-fsc", "cbs405"])
def test_fsc_statics_and_meta_match_jax(mode):
    tp, jp, tst, jst = _fsc_setup(mode)
    assert tst.fsc_mode == jst.fsc_mode is not None
    tc.assert_same(tst, jst, f"RasterStatics({mode})")
    n = 3 * tp.conf.lines + 2
    tc.assert_same(tp.line_meta(-1, n), jp.line_meta(-1, n), "line_meta")


@pytest.mark.parametrize("mode", ["apollo-fsc", "cbs405"])
def test_fsc_synth_block_matches_jax(mode):
    """synth_block on three grey planes of a seeded random frame, over
    three frames' lines (every field and both flag pulses)."""
    tp, jp, tst, jst = _fsc_setup(mode)
    h, w = tp.conf.active_lines, tp.active_width
    rgb = np.random.default_rng(3).integers(0, 256, (h, w, 3),
                                            dtype=np.uint8)
    planes = np.stack([traster.rgb_to_yuv_host(
        tp, np.repeat(rgb[..., c:c + 1], 3, axis=-1))[0]
        for c in (2, 1, 0)])
    zero = np.zeros_like(planes[0])
    meta = tp.line_meta(-1, 3 * tp.conf.lines + 2)
    ix = ("base", "nxt", "vy", "al", "ar", "lut_row", "prv", "fsc", "fscf")
    fl = ("burst", "vswitch", "cos0", "sin0")
    t = {k: torch.as_tensor(meta[k].astype(np.int64)) for k in ix}
    t.update({k: torch.as_tensor(meta[k].astype(np.float32)) for k in fl})
    got = traster.synth_block(
        traster.to_device(tst, "cpu"),
        tuple(torch.as_tensor(a) for a in (planes, zero, zero)), t["base"],
        t["nxt"], t["burst"], t["vswitch"], t["vy"], t["al"], t["ar"],
        t["cos0"], t["sin0"], t["lut_row"], t["prv"], t["fsc"],
        t["fscf"]).numpy()
    jfn = jax.jit(functools.partial(jraster.synth_block, jst))
    j = {k: jnp.asarray(meta[k].astype(np.float32) if k in fl else meta[k])
         for k in ix + fl}
    ref = np.asarray(jfn(tuple(jnp.asarray(a) for a in (planes, zero, zero)),
                         j["base"], j["nxt"], j["burst"], j["vswitch"],
                         j["vy"], j["al"], j["ar"], j["cos0"], j["sin0"],
                         j["lut_row"], j["fsc"], j["fscf"], j["prv"]))
    tc.assert_same(got, ref, f"synth_block({mode})")
    # the flags and the fields are really there
    assert np.count_nonzero(meta["fscf"]) > 0
    assert set(np.unique(meta["fsc"])) == {0, 1, 2}


def test_rotated_modes_swap_the_test_card():
    """The quarter-turn modes build the test card with its sides swapped
    and read it rotated to scan order."""
    for mode in ("30", "nbtv"):
        conf = tget_mode(mode)
        assert conf.frame_orientation & 3 in (1, 3)
        t = TEncoder(mode, MODES[mode], device="cpu")
        inner = t.source.inner
        assert (inner.width, inner.height) == (conf.active_lines,
                                               t.params.active_width)
        assert (t.source.width, t.source.height) == (inner.height,
                                                     inner.width)
