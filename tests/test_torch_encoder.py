"""The port's Encoder against hacktv_tpu's, end to end on the CPU: two
sequential one-frame blocks of each configuration, with seeded noise for
sound.  Every configuration is byte-identical, NTSC-M's FM sound
included, and so is each with the JAX encoder's statics carried over
through convert.py."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import convert
from hacktv_tpu_torch.av.noise import NoiseSource

CONFIGS = {
    "m-vsb": ("m", 13_500_000, True),
    "pal-filter": ("pal", 16_000_000, True),
    "pal": ("pal", 16_000_000, False),
    "m": ("m", 13_500_000, False),
}
_JAX: dict = {}


def _source(mode, rate):
    enc = TEncoder(mode, rate, device="cpu")
    return NoiseSource(enc.params.active_width, enc.conf.active_lines,
                       seed=7)


def _jax_blocks(name):
    """The JAX encoder's first two blocks, computed once per config."""
    if name not in _JAX:
        mode, rate, vf = CONFIGS[name]
        src = _source(mode, rate)
        j = JEncoder(mode, rate, vfilter=vf, source=src)
        _JAX[name] = (j, src, [j.encode_block(b) for b in range(2)])
    return _JAX[name]


def _jax_statics(j) -> dict:
    """The JAX encoder's statics under its own field names."""
    st = j.statics
    out = {f: np.asarray(getattr(st, f)) for f in convert.RASTER_FIELDS
           if getattr(st, f) is not None and f != "carrier_rows"}
    if st.carrier_rows is not None:
        out["carrier_rows"] = np.stack([np.asarray(a)
                                        for a in st.carrier_rows])
    if j.params.vfilter_ctaps is not None:
        out["vfilter_ctaps"] = j.params.vfilter_ctaps
    elif j.params.vfilter_taps is not None:
        out["vfilter_taps"] = j.params.vfilter_taps
    if j.fm_statics is not None:
        out["cos_x"] = np.asarray(j.fm_statics.cos_x)
        out["sin_x"] = np.asarray(j.fm_statics.sin_x)
        out["lens_tiled"] = np.asarray(j.fm_win.lens_tiled)
    return out


def _check(name, got, ref, block):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    snr, maxerr, ndiff = tc.error_report(got, ref)
    msg = (f"{name} block {block}: SNR {snr:.1f} dB, max error {maxerr}, "
           f"{ndiff} of {ref.size} samples differ")
    assert ndiff == 0 and maxerr == 0 and snr == np.inf, msg


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_matches_jax(name):
    mode, rate, vf = CONFIGS[name]
    _, src, ref = _jax_blocks(name)
    t = TEncoder(mode, rate, vfilter=vf, source=src, device="cpu")
    for b in range(2):
        _check(name, t.encode_block(b), ref[b], b)


@pytest.mark.parametrize("name", ["m-vsb", "pal-filter"])
def test_statics_carry_over(name):
    mode, rate, vf = CONFIGS[name]
    j, src, ref = _jax_blocks(name)
    t = TEncoder(mode, rate, vfilter=vf, source=src, device="cpu")
    arrays = _jax_statics(j)
    tc.assert_same(convert.statics_to_numpy(t), arrays, "statics")
    other = TEncoder(mode, rate, vfilter=vf, source=src, device="cpu")
    convert.statics_from_numpy(other, arrays)
    tc.assert_same(convert.statics_to_numpy(other), arrays, "installed")
    for b in range(2):
        _check(name, other.encode_block(b), ref[b], b)


# name: (mode, sample rate, Encoder arguments)
CARRY = {"apollo-fsc": ("apollo-fsc", 14_000_000, {}),
         "i-pixelrate": ("i", 16_000_000, {"pixel_rate": 14_750_000})}


@pytest.mark.parametrize("name", sorted(CARRY))
def test_statics_carry_over_fsc_and_resampler(name):
    """The FSC flag templates and the video resampler's bank and class
    windows, taken from the JAX encoder, equal the port's under
    convert.py's names; installed on a second port encoder (with the
    port's own other statics) they give the JAX encoder's bytes."""
    mode, rate, kw = CARRY[name]
    t = TEncoder(mode, rate, device="cpu", **kw)
    src = NoiseSource(t.params.active_width, t.conf.active_lines, seed=3)
    j = JEncoder(mode, rate, source=src, **kw)
    want = {}
    if j.statics.fsc_tpl is not None:
        want["fsc_tpl"] = np.asarray(j.statics.fsc_tpl)
    if j.resampler is not None:
        want["resampler.rs.T"] = j.resampler.rs.T
        for f in convert.RESAMPLER_FIELDS:
            want["resampler." + f] = getattr(j.resampler, f)
    assert want
    t = TEncoder(mode, rate, source=src, device="cpu", **kw)
    arrays = convert.statics_to_numpy(t)
    tc.assert_same({k: arrays[k] for k in want}, want, "statics")
    other = TEncoder(mode, rate, source=src, device="cpu", **kw)
    convert.statics_from_numpy(other, {**arrays, **want})
    tc.assert_same(convert.statics_to_numpy(other), arrays, "installed")
    for b in range(2):
        _check(name, other.encode_block(b), j.encode_block(b), b)


def test_blocks_must_be_sequential():
    t = TEncoder("m", 13_500_000, vfilter=True, device="cpu")
    t.encode_block_device(0)
    with pytest.raises(RuntimeError):
        t.encode_block_device(2)


@pytest.mark.parametrize("mode,kw,exc", [
    ("l", {"pixel_rate": 13_500_000}, NotImplementedError),
    ("d2mac", {"devices": ["cpu"] * 3}, ValueError),
    ("pal", {"devices": ["cpu"] * 3}, ValueError),
    ("pal", {"eurocrypt": "filmnet"}, NotImplementedError),
    ("d2mac-fm", {"devices": ["cpu"] * 7}, ValueError)],
    ids=["l-kw0", "d2mac-kw1", "pal-kw2", "pal-kw3", "d2mac-fm-kw4"])
def test_unported_options_raise(mode, kw, exc):
    """Options the port does not cover (SECAM with --pixelrate, which the
    JAX package cannot run either; Eurocrypt outside MAC), and, for the
    line-axis sharding over devices of both encoders, a block whose
    lines do not divide over the devices (625 over 3 and 7)."""
    from hacktv_tpu_torch.config.standards import get_mode
    from hacktv_tpu_torch.video.mac import MacEncoder
    cls = MacEncoder if get_mode(mode).mac_mode is not None else TEncoder
    with pytest.raises(exc):
        cls(mode, 16_000_000, device="cpu", **kw)
