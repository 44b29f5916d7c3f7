"""The video resampler (`--pixelrate`, ops/resampler.py) against
hacktv_tpu on the CPU.

Module level: `Resampler.create`'s polyphase bank, `make_block_statics`'
fields and `device_resample_block` on seeded inputs, byte for byte, on
both of its branches (windows within one row of `stride` inputs, L/M =
64/59; windows across rows, L/M = 1/2 and 3/2), and with a bank built to
drive window sums past 2^31, where the JAX package's int32 accumulator
wraps.  Encoder level: PAL-I at 16 MS/s from 14.75 MS/s pixels with and
without the VSB filter, PAL at 8 MS/s from 16 MS/s, PAL-FM at 20.25 MS/s
from 13.5 MS/s, one-frame blocks 0-2; misaligned widths raise the JAX
package's ValueError, and SECAM with --pixelrate is refused."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu.ops import resampler as jrs
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch.av.noise import NoiseSource
from hacktv_tpu_torch.ops import resampler as trs

# name: (sample rate, pixel rate, pixel width, output width)
RATIOS = {"i-64/59": (16_000_000, 14_750_000, 944, 1024),
          "pal-1/2": (8_000_000, 16_000_000, 1024, 512),
          "pal-fm-3/2": (20_250_000, 13_500_000, 864, 1296)}
NLINES = 625


def _statics(name, nlines=NLINES):
    out, px, wpx, wout = RATIOS[name]
    return (trs.make_block_statics(trs.Resampler.create(out, px), wpx, wout,
                                   nlines),
            jrs.make_block_statics(jrs.Resampler.create(out, px), wpx, wout,
                                   nlines))


def _resample_both(t_st, j_st, flat):
    got = trs.device_resample_block(t_st, torch.as_tensor(flat)).numpy()
    ref = np.asarray(jax.jit(lambda f: jrs.device_resample_block(j_st, f))(
        jnp.asarray(flat)))
    tc.assert_same(got, ref, "resampled")
    return got


@pytest.mark.parametrize("name", sorted(RATIOS))
def test_bank_and_statics_match_jax(name):
    out, px, _, _ = RATIOS[name]
    tc.assert_same(trs.Resampler.create(out, px),
                   jrs.Resampler.create(out, px), "Resampler")
    t_st, j_st = _statics(name)
    tc.assert_same(t_st, j_st, "BlockResampleStatics")
    # the branch each ratio takes
    assert (t_st.rs.A <= t_st.stride) == (name == "i-64/59")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(RATIOS))
def test_device_resample_block_matches_jax(name, seed):
    """A seeded composite-like stream, f32 with fractions (rounded half to
    even first) and values past int16 (clipped), over a one-frame block
    and its halo lines; a short input is padded with zeros."""
    t_st, j_st = _statics(name)
    wpx = RATIOS[name][2]
    rng = np.random.default_rng(seed)
    flat = (rng.standard_normal((NLINES + 2) * wpx) * 15000).astype(
        np.float32)
    flat[::97] = np.float32(40000.5)
    flat[1::89] = np.float32(-2.5)
    got = _resample_both(t_st, j_st, flat)
    assert got.shape == ((NLINES + 2) * RATIOS[name][3],)
    _resample_both(t_st, j_st, flat[:-3 * wpx])


@pytest.mark.parametrize("name", sorted(RATIOS))
def test_int32_wraparound_matches_jax(name):
    """Every tap at 32767 and a full-scale input: each window sum is about
    22 * 2^30, past int32, so the result is the wrapped sum's shift."""
    t_st, j_st = _statics(name)
    t_st = dataclasses.replace(t_st, Td=np.full_like(t_st.Td, 32767))
    j_st = dataclasses.replace(j_st, Td=np.full_like(j_st.Td, 32767))
    wpx = RATIOS[name][2]
    flat = np.full((NLINES + 2) * wpx, 32767.0, np.float32)
    flat[::5] = -32768.0
    got = _resample_both(t_st, j_st, flat)
    # unwrapped, every sum of 22 or 21 taps past 2^30 would clip to
    # +32767; wrapped, a good share of them do not
    assert t_st.rs.A * 32767 * 32767 > 2 ** 31
    assert np.count_nonzero(got != 32767) > got.size // 10


@pytest.mark.parametrize("name", sorted(RATIOS))
def test_host_reference_agrees(name):
    """The host reference (resample_block, the reference's streaming
    semantics) against the block resample in the middle of a stream."""
    t_st, _ = _statics(name, nlines=4)
    out, px, wpx, wout = RATIOS[name]
    rs = t_st.rs
    rng = np.random.default_rng(2)
    x = rng.integers(-20000, 20000, 8 * wpx).astype(np.float32)
    # block 1 of 4-line blocks: lines 3..8 of the stream, flat from line 3
    dev = trs.device_resample_block(t_st, torch.as_tensor(x[3 * wpx:]))
    host = rs.resample_block(x.astype(np.int64), m0=4 * wout,
                             n_out=6 * wout)
    n = min(len(dev), len(host)) - 2 * wout     # away from the padded end
    tc.assert_same(dev.numpy()[:n].astype(np.int16), host[:n], "host")


# name: (mode, sample rate, pixel rate, Encoder arguments)
ENCODERS = {"i": ("i", 16_000_000, 14_750_000, {}),
            "i-filter": ("i", 16_000_000, 14_750_000, {"vfilter": True}),
            "pal-8/16": ("pal", 8_000_000, 16_000_000, {}),
            "pal-fm": ("pal-fm", 20_250_000, 13_500_000, {})}
BLOCKS = 3


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_matches_jax(name):
    mode, rate, px, kw = ENCODERS[name]
    if mode == "pal-fm":
        tc.jax_runtime()
    t = TEncoder(mode, rate, pixel_rate=px, device="cpu", **kw)
    src = NoiseSource(t.params.active_width, t.conf.active_lines, seed=4)
    t = TEncoder(mode, rate, pixel_rate=px, source=src, device="cpu", **kw)
    j = JEncoder(mode, rate, pixel_rate=px, source=src, **kw)
    assert t.out_params.width == j.out_params.width != t.params.width
    assert t.frame_samples == j.frame_samples
    for b in range(BLOCKS):
        got, ref = t.encode_block(b), j.encode_block(b)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        snr, maxerr, ndiff = tc.error_report(got, ref)
        assert ndiff == 0, (f"{name} block {b}: {ndiff} of {ref.size} "
                            f"differ, max {maxerr}, {snr:.1f} dB")


def test_misaligned_widths_raise_like_jax():
    """NTSC-M's 890 samples a line at 14 MS/s against its 858 pixels at
    13.5 MS/s are not in the ratio 28/27."""
    with pytest.raises(ValueError) as te:
        TEncoder("m", 14_000_000, pixel_rate=13_500_000, device="cpu")
    with pytest.raises(ValueError) as je:
        JEncoder("m", 14_000_000, pixel_rate=13_500_000)
    assert str(te.value) == str(je.value)


def test_secam_with_pixelrate_refused():
    """The JAX package lays SECAM's chroma out at the output width over a
    raster at the pixel width and fails as it encodes; the port refuses
    the combination when it is built."""
    with pytest.raises(NotImplementedError, match="SECAM with --pixelrate"):
        TEncoder("l", 16_000_000, pixel_rate=13_500_000, device="cpu")
    with pytest.raises(IndexError):
        JEncoder("l", 16_000_000, pixel_rate=13_500_000).encode_block(0)
