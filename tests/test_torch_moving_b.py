"""The moving path, continued (test_torch_moving.py has the rest):
S-Video, the --pixelrate resampler, a rotated mode (NBTV), NTSC with
CEA-608 pairs read from the source, and a raw RGB32 file through the fit
geometry and the input sequence, each at 4 frames a block, blocks 0-1
byte-identical to hacktv_tpu.Encoder on the same seeded frames."""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest

import _torch_common as tc
from hacktv_tpu.av import frame_ops as jfo
from hacktv_tpu.av.rawfile import RawFileSource as JRaw
from hacktv_tpu.av.sequence import SequenceSource as JSeq
from hacktv_tpu.config.standards import get_mode as jget_mode
from hacktv_tpu.encoder import Encoder as JEncoder
from hacktv_tpu.rational import Rational as JRational
from hacktv_tpu_torch.av import frame_ops
from hacktv_tpu_torch.av.rawfile import RawFileSource
from hacktv_tpu_torch.av.sequence import SequenceSource
from hacktv_tpu_torch.config import get_mode
from hacktv_tpu_torch.encoder import Encoder
from hacktv_tpu_torch.rational import Rational

BLOCKS = 2


def check(make_t, make_j, blocks=BLOCKS):
    t, j = make_t(), make_j()
    for b in range(blocks):
        a, r = t.encode_block(b), j.encode_block(b)
        assert a.shape == r.shape, (b, a.shape, r.shape)
        _, mx, nd = tc.error_report(a, r)
        assert nd == 0, f"block {b}: {nd} samples differ (max {mx})"
    return t


@pytest.mark.parametrize("case", ["pal-svideo", "i-pixelrate", "nbtv"])
def test_moving_matches_jax(case):
    """S-Video (luma and chroma on two channels), PAL-I synthesised at
    14.75 MS/s and resampled to 16 MS/s, and NBTV's vertical scan (the
    frame rotated a quarter turn before it is stacked)."""
    mode, rate, kw, size = {
        "pal-svideo": ("pal", 16_000_000, {}, (160, 100)),
        "i-pixelrate": ("i", 16_000_000, {"pixel_rate": 14_750_000},
                        (160, 100)),
        "nbtv": ("nbtv", 100_000, {}, (32, 48)),
    }[case]
    tconf, jconf = get_mode(mode), jget_mode(mode)
    if case == "pal-svideo":
        tconf, jconf = (replace(c, s_video=True) for c in (tconf, jconf))
    kw = dict(kw, frames_per_block=4)
    t = check(lambda: Encoder(tconf, rate, source=tc.MovingSource(*size),
                              device="cpu", **kw),
              lambda: JEncoder(jconf, rate, source=tc.MovingSource(*size),
                               **kw))
    assert t._multi_frame


def test_ntsc_cc608_from_source():
    """NTSC-M with CEA-608: the pairs come from the source's read_cc608,
    one a frame, across 4-frame blocks."""
    kw = dict(frames_per_block=4, cc608=True)
    t = check(lambda: Encoder("ntsc", 13_500_000, device="cpu",
                              source=tc.MovingSource(160, 100), **kw),
              lambda: JEncoder("ntsc", 13_500_000,
                               source=tc.MovingSource(160, 100), **kw))
    assert t.services[0]._cc_frame == 8


def test_raw_file_through_fit_and_sequence(tmp_path):
    """PAL-I with the VSB filter from a raw RGB32 file of another size
    (with its .pcm sound), stretched to the active size by FitSource and
    looped by SequenceSource: the chip path's input chain at a small
    size."""
    src = tc.MovingSource(120, 90, nframes=5)
    raw = np.stack([(f.astype(np.uint32) << np.array([16, 8, 0], np.uint32)
                     ).sum(-1, dtype=np.uint32) | 0xFF000000
                    for f in src.frames])
    path = tmp_path / "clip.raw"
    raw.tofile(path)
    src.noise[:32000].tofile(str(path) + ".pcm")
    spec = f"{path}:120x90"
    p = Encoder("i", 16_000_000, device="cpu").params
    size = (p.active_width, 576)

    def make(raw_cls, fit_mod, seq_cls, rat, enc_cls, **dev):
        cfg = fit_mod.FitConfig(*size, display_aspect_ratios=(rat(4, 3),))
        s = seq_cls([fit_mod.FitSource(raw_cls(spec, *size), cfg)],
                    repeat=True)
        return enc_cls("i", 16_000_000, vfilter=True, frames_per_block=4,
                       source=s, **dev)
    t = check(lambda: make(RawFileSource, frame_ops, SequenceSource,
                           Rational, Encoder, device="cpu"),
              lambda: make(JRaw, jfo, JSeq, JRational, JEncoder))
    assert t._multi_frame and t.source.width == size[0]
