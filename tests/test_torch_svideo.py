"""S-Video (`--s-video`) against hacktv_tpu on the CPU: luma and chroma
on two channels.  The raster's split equals the JAX package's, and whole
encoders are byte-identical over one-frame blocks 0-2: PAL with and
without the low-pass (which filters the C channel too, a second stream
FIR per block), SECAM with its carrier on the C channel (the device
chroma program and the host-exact one), PAL-I with the VSB filter (whose
Q output the C channel replaces) and PAL-FM.  S-Video with --pixelrate is
refused, as in the JAX package."""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu.config import get_mode as jget_mode
from hacktv_tpu.video import params as jparams
from hacktv_tpu.video import raster as jraster
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import encoder as tencoder
from hacktv_tpu_torch.av import testcard as ttc
from hacktv_tpu_torch.av.noise import NoiseSource
from hacktv_tpu_torch.config import get_mode as tget_mode
from hacktv_tpu_torch.video import params as tparams
from hacktv_tpu_torch.video import raster as traster

RATE = 16_000_000
# name: (mode, Encoder arguments)
CONFIGS = {
    "pal": ("pal", {}),
    "pal-filter": ("pal", {"vfilter": True}),
    "secam": ("secam", {}),
    "secam-exact": ("secam", {"secam_exact": True}),
    "i-filter": ("i", {"vfilter": True}),
    "pal-fm": ("pal-fm", {}),
}
BLOCKS = 3
_JAX: dict = {}


def _jax_blocks(name):
    if name not in _JAX:
        mode, kw = CONFIGS[name]
        if mode == "pal-fm":
            tc.jax_runtime()
        probe = TEncoder(mode, RATE, device="cpu")
        src = NoiseSource(probe.params.active_width, probe.conf.active_lines,
                          seed=11)
        j = JEncoder(replace(jget_mode(mode), s_video=True), RATE,
                     source=src, **kw)
        assert j.complex_out
        _JAX[name] = (src, [j.encode_block(b) for b in range(BLOCKS)])
    return _JAX[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_svideo_encoder_matches_jax(name):
    mode, kw = CONFIGS[name]
    src, ref = _jax_blocks(name)
    t = TEncoder(replace(tget_mode(mode), s_video=True), RATE, source=src,
                 device="cpu", **kw)
    assert t.complex_out
    for b in range(BLOCKS):
        got = t.encode_block(b)
        assert got.shape == ref[b].shape and got.dtype == ref[b].dtype
        assert got.ndim == 2 and got.shape[1] == 2
        snr, maxerr, ndiff = tc.error_report(got, ref[b])
        assert ndiff == 0, (f"{name} block {b}: {ndiff} of {ref[b].size} "
                            f"differ, max {maxerr}, {snr:.1f} dB")
    if name in ("pal", "secam"):
        # the C channel carries the colour, the luma none of it
        assert np.count_nonzero(got[:, 1]) > 0


def test_lowpass_filters_both_channels(monkeypatch):
    """With the real low-pass, each block runs the stream FIR twice, on Y
    and on C; with the VSB filter once, on Y."""
    calls = []
    real = tencoder.stream_fir

    def counting(xs, taps_r, taps_i, n):
        calls.append(taps_i is None)
        return real(xs, taps_r, taps_i, n)
    monkeypatch.setattr(tencoder, "stream_fir", counting)
    for mode, want in (("pal", [True, True]), ("i", [False])):
        calls.clear()
        TEncoder(replace(tget_mode(mode), s_video=True), RATE, vfilter=True,
                 device="cpu").encode_block(0)
        assert calls == want, mode


@functools.lru_cache(maxsize=None)
def _pal_setup():
    tp = tparams.VideoParams.create(tget_mode("pal"), RATE, 0)
    jp = jparams.VideoParams.create(jget_mode("pal"), RATE, 0)
    w = tp.active_width
    return (tp, traster.to_device(traster.make_statics(tp, 0, w), "cpu"),
            jraster.make_statics(jp, 0, w))


def test_split_chroma_matches_jax():
    """synth_block(split_chroma=True) on the PAL test card: the composite
    without chroma and the chroma channel, each equal to the JAX
    package's, and their sum the composite."""
    tp, tst, jst = _pal_setup()
    yuv = traster.rgb_to_yuv_host(
        tp, ttc.test_card_rgb(tp.active_width, tp.conf.active_lines))
    meta = tp.line_meta(-1, tp.conf.lines + 2)
    ix = ("base", "nxt", "vy", "al", "ar", "lut_row", "prv", "fsc", "fscf")
    fl = ("burst", "vswitch", "cos0", "sin0")
    t = {k: torch.as_tensor(meta[k].astype(np.int64)) for k in ix}
    t.update({k: torch.as_tensor(meta[k].astype(np.float32)) for k in fl})
    args = (tuple(torch.as_tensor(a) for a in yuv), t["base"], t["nxt"],
            t["burst"], t["vswitch"], t["vy"], t["al"], t["ar"], t["cos0"],
            t["sin0"], t["lut_row"], t["prv"], t["fsc"], t["fscf"])
    y, c = traster.synth_block(tst, *args, split_chroma=True)
    jfn = jax.jit(functools.partial(jraster.synth_block, jst,
                                    split_chroma=True))
    j = {k: jnp.asarray(meta[k].astype(np.float32) if k in fl else meta[k])
         for k in ix + fl}
    jy, jc = jfn(tuple(jnp.asarray(a) for a in yuv), j["base"], j["nxt"],
                 j["burst"], j["vswitch"], j["vy"], j["al"], j["ar"],
                 j["cos0"], j["sin0"], j["lut_row"], j["fsc"], j["fscf"],
                 j["prv"])
    tc.assert_same(y.numpy(), np.asarray(jy), "luma channel")
    tc.assert_same(c.numpy(), np.asarray(jc), "chroma channel")
    both = traster.synth_block(tst, *args)
    assert torch.equal(both, y + c)


def test_svideo_with_pixelrate_raises():
    conf = replace(tget_mode("pal"), s_video=True)
    with pytest.raises(NotImplementedError,
                       match="--pixelrate with --s-video"):
        TEncoder(conf, 8_000_000, pixel_rate=RATE, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="--pixelrate with --s-video"):
        JEncoder(replace(jget_mode("pal"), s_video=True), 8_000_000,
                 pixel_rate=RATE)
