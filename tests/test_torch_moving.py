"""The moving path of the port's Encoder against hacktv_tpu.Encoder on
the same seeded frames: multi-frame blocks (fpb + 2 frames stacked,
converted on the device through the 16M-entry LUT, gathered by absolute
row) byte-identical to the JAX package's at fpb=4, and to the port's own
fpb=1 stream; moving SECAM-L with the carrier's phase past 120 rad
(glibc's large-argument reduction), SECAM-FM on its host-exact chroma,
PAL-FM; and the LUT itself against the JAX package's for the PAL and
SECAM keys.  The rest of the moving cases are in
test_torch_moving_b.py."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import _torch_common as tc
from hacktv_tpu.encoder import Encoder as JEncoder
from hacktv_tpu.video import raster as jraster
from hacktv_tpu.video.params import VideoParams as JParams
from hacktv_tpu_torch.config import get_mode
from hacktv_tpu_torch.encoder import Encoder
from hacktv_tpu_torch.video import raster
from hacktv_tpu_torch.video.params import VideoParams

BLOCKS = 2


def run(enc, blocks=BLOCKS):
    return [enc.encode_block(b) for b in range(blocks)]


def same(got, ref):
    for b, (a, r) in enumerate(zip(got, ref)):
        assert a.shape == r.shape, (b, a.shape, r.shape)
        _, mx, nd = tc.error_report(a, r)
        assert nd == 0, f"block {b}: {nd} samples differ (max {mx})"


def test_i_filter_multi_frame_matches_jax():
    """PAL-I with the VSB filter, NICAM and FM sound, 4-frame blocks."""
    kw = dict(frames_per_block=4, vfilter=True)
    t = Encoder("i", 16_000_000, source=tc.MovingSource(160, 100),
                device="cpu", **kw)
    assert t._multi_frame and t._nf == 6
    j = JEncoder("i", 16_000_000, source=tc.MovingSource(160, 100), **kw)
    same(run(t), run(j))


def test_multi_frame_matches_single_frame():
    """The port at fpb=4 writes the port's fpb=1 stream, on a source
    holding its last frame past the end (blocks 0-2: 12 frames)."""
    src = lambda: tc.MovingSource(160, 100, nframes=9)
    a = Encoder("pal", 16_000_000, frames_per_block=4, source=src(),
                device="cpu")
    b = Encoder("pal", 16_000_000, frames_per_block=1, source=src(),
                device="cpu")
    xa = np.concatenate([x.reshape(-1) for x in run(a, 3)])
    xb = np.concatenate([x.reshape(-1) for x in run(b, 12)])
    assert np.array_equal(xa, xb)


def test_secam_l_moving_phase_past_120_rad(capsys):
    """SECAM-L on saturated moving colour, device chroma: the carrier's
    phase passes 120 rad (with the small-argument path only, the port's
    sin/cos refuses it), and blocks 0-1 equal the JAX package's.  SECAM
    does not stack frames: at fpb=4 both repeat each block's first frame
    and warn once."""
    p = VideoParams.create(get_mode("l"), 16_000_000)
    src = lambda: tc.MovingSource(p.active_width, 288, saturated=True)
    t = Encoder("l", 16_000_000, frames_per_block=4, source=src(),
                device="cpu")
    assert t.secam.large and t._dev_convert and not t._multi_frame
    j = JEncoder("l", 16_000_000, frames_per_block=4, source=src())
    same(run(t), run(j))
    err = capsys.readouterr().err
    assert err.count("hacktv_tpu_torch: warning: frames_per_block=4 with "
                     "a non-static source repeats each block's first "
                     "frame") == 1
    small = Encoder("l", 16_000_000, source=src(), device="cpu")
    small.secam = dataclasses.replace(small.secam, large=False)
    with pytest.raises(RuntimeError, match="120"):
        small.encode_block(0)


@pytest.mark.parametrize("mode,rate", [("secam-fm", 16_000_000),
                                       ("pal-fm", 20_250_000)])
def test_fm_video_moving_matches_jax(mode, rate):
    """SECAM-FM (host-exact chroma, host conversion, one-frame blocks
    from a moving source: the warning case) and PAL-FM with its
    pre-emphasis filter at 20.25 MS/s (multi-frame)."""
    tc.jax_runtime()
    kw = dict(frames_per_block=1 if mode == "secam-fm" else 4,
              vfilter=mode == "pal-fm")
    src = lambda: tc.MovingSource(200, 150, saturated=mode == "secam-fm")
    t = Encoder(mode, rate, source=src(), device="cpu", **kw)
    assert t._dev_convert == (mode == "pal-fm")
    j = JEncoder(mode, rate, source=src(), **kw)
    same(run(t), run(j))


@pytest.mark.parametrize("mode,secam", [("i", False), ("l", True)])
def test_lut_matches_jax(mode, secam):
    """The 16M-entry LUT equals the JAX package's build_yuv_lut for the
    PAL key and for the SECAM key, and gathers to rgb_to_yuv_host."""
    tp = VideoParams.create(get_mode(mode), 16_000_000)
    jp = JParams.create(__import__("hacktv_tpu.config.standards",
                                   fromlist=["get_mode"]).get_mode(mode),
                        16_000_000)
    lut = raster.build_yuv_lut(tp, secam)
    assert lut.tobytes() == jraster.build_yuv_lut(jp, secam).tobytes()
    import torch
    rgb = tc.MovingSource(64, 32, saturated=secam).read_video(3)
    got = raster.yuv_convert_device(torch.as_tensor(lut),
                                    torch.as_tensor(rgb))
    ref = raster.rgb_to_yuv_host(tp, rgb, secam)
    for g, r in zip(got, ref):
        assert g.numpy().tobytes() == r.tobytes()
