"""The port's fit geometry (av/frame_ops.py) against hacktv_tpu's:
calculate_frame_size over the four fit modes at each size of the
reference's DVD/DVB adjustment table (src/av.c:106-122) and at sizes
outside it, with one display ratio and with the MAC pair, with aspect
limits, and FitSource's scaled frames, borders and pixel aspect ratio."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_common as tc
from hacktv_tpu.av import frame_ops as jfo
from hacktv_tpu.rational import Rational as JR
from hacktv_tpu_torch.av import frame_ops as tfo
from hacktv_tpu_torch.rational import Rational as TR

MODES = ["stretch", "fill", "fit", "none"]
SIZES = [rn for rn, _ in jfo._FADJ] + [(1280, 720), (640, 480),
                                       (500, 500), (1920, 800)]


def cfgs(mode, ratios=((4, 3),), lo=None, hi=None, size=(702, 576)):
    mk = lambda fo, R: fo.FitConfig(
        *size, fit_mode=mode,
        display_aspect_ratios=tuple(R(*r) for r in ratios),
        min_display_aspect_ratio=R(*lo) if lo else None,
        max_display_aspect_ratio=R(*hi) if hi else None)
    return mk(tfo, TR), mk(jfo, JR)


def test_fadj_table_is_the_same():
    assert tfo._FADJ == jfo._FADJ


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_calculate_frame_size(mode, size):
    """Square pixels and a 16:11 PAR (anamorphic 4:3 DVD), each with the
    4:3 display and with the MAC pair 4:3/16:9."""
    for ratios in (((4, 3),), ((4, 3), (16, 9))):
        t, j = cfgs(mode, ratios)
        for par in ((1, 1), (16, 11)):
            tdar = tfo.display_aspect_ratio(*size, TR(*par))
            jdar = jfo.display_aspect_ratio(*size, JR(*par))
            got = tfo.calculate_frame_size(t, TR(*size), tdar)
            ref = jfo.calculate_frame_size(j, JR(*size), jdar)
            assert got == ref, (ratios, par)


@pytest.mark.parametrize("lo,hi", [((14, 9), None), (None, (14, 9)),
                                   ((4, 3), (16, 9))])
def test_aspect_limits(lo, hi):
    for size in SIZES:
        for mode in ("fill", "fit"):
            t, j = cfgs(mode, lo=lo, hi=hi)
            got = tfo.calculate_frame_size(t, TR(*size), None)
            ref = jfo.calculate_frame_size(j, JR(*size), None)
            assert got == ref, (size, mode)


class _Frames:
    """A source of seeded frames at one size (not the active size)."""

    interlaced = 0

    def __init__(self, w, h):
        self.width, self.height = w, h
        self.frames = [np.random.default_rng(f).integers(
            0, 256, (h, w, 3), dtype=np.uint8) for f in range(3)]

    def read_video(self, n):
        return self.frames[n % 3]

    def read_audio(self, start, count):
        return np.zeros((count, 2), np.int16)

    def read_cc608(self, n):
        return (n, n + 1)

    def eof(self, n):
        return n >= 3


@pytest.mark.parametrize("case", [
    ("fit", (1280, 720), (1, 1), ((4, 3),), 0, False, False),   # letterbox
    ("fit", (500, 500), (1, 1), ((4, 3),), 0, False, False),    # pillarbox
    ("stretch", (120, 90), (1, 1), ((4, 3),), 0, False, False),
    ("none", (320, 200), (1, 1), ((4, 3),), 0, False, False),
    ("fill", (720, 576), (16, 11), ((4, 3), (16, 9)), 0, False, False),
    ("fit", (640, 480), (1, 1), ((16, 9),), 1, True, False),
    ("fit", (300, 400), (1, 1), ((4, 3),), 2, False, True),
], ids=["letterbox", "pillarbox", "stretch", "none", "fill-mac-par",
        "rotate-hflip", "rotate2-vflip"])
def test_fitsource_frames(case):
    mode, size, par, ratios, rot, hf, vf = case
    t, j = cfgs(mode, ratios)
    src = _Frames(*size)
    ts = tfo.FitSource(src, t, rotate_a=rot, do_hflip=hf, do_vflip=vf,
                       par=TR(*par))
    js = jfo.FitSource(src, j, rotate_a=rot, do_hflip=hf, do_vflip=vf,
                       par=JR(*par))
    assert (ts.width, ts.height) == (js.width, js.height) == (702, 576)
    for n in range(3):
        a, b = ts.read_video(n), js.read_video(n)
        tc.assert_same(a, b, f"frame {n}")
        assert ts.pixel_aspect_ratio == js.pixel_aspect_ratio
        assert ts.read_cc608(n) == js.read_cc608(n)
    assert ts.eof(3) and not ts.eof(2)
    if mode == "fit" and size == (1280, 720):
        vh = 576 * (4 * 9) // (3 * 16)
        y0 = (576 - vh) // 2
        out = ts.read_video(0)
        assert not out[:y0].any() and not out[y0 + vh:].any()


def test_crop_and_scale_nearest():
    rgb = _Frames(64, 48).read_video(1)
    for x, y, w, h in ((4, 2, 30, 20), (-3, -5, 70, 60), (60, 40, 10, 10)):
        tc.assert_same(tfo.crop(rgb, x, y, w, h), jfo.crop(rgb, x, y, w, h))
    for w, h in ((100, 30), (13, 77), (64, 48)):
        tc.assert_same(tfo.scale_nearest(rgb, w, h),
                       jfo.scale_nearest(rgb, w, h))
