"""Frame geometry: fit modes, aspect maths and orientation ops.

Array equivalents of the reference's stride tricks and rational aspect
maths (src/av.c:103-303): `calculate_frame_size` reproduces the
stretch/fill/fit/none letterbox/pillarbox computation including the
DVD/DVB horizontal-resolution adjustment table; the orientation ops are
O(1) numpy views just as the reference's are stride flips.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..rational import Rational

FIT_STRETCH = "stretch"
FIT_FILL = "fill"
FIT_FIT = "fit"
FIT_NONE = "none"

# Horizontal resolution adjustment factors (src/av.c:106-122)
_FADJ = [
    ((720, 576), (720, 702)),
    ((704, 576), (704, 702)),
    ((544, 576), (1088, 1053)),
    ((480, 576), (480, 468)),
    ((384, 288), (768, 767)),
    ((352, 576), (352, 351)),
    ((352, 288), (352, 351)),
    ((176, 144), (352, 351)),
    ((720, 480), (1600, 1587)),
    ((704, 480), (14080, 14283)),
]


def _nearest(r: Rational, a: Rational, b: Rational) -> Rational:
    """The ratio closer to r (src/common.c r64_nearest)."""
    da = abs(r.num * a.den * b.den - a.num * r.den * b.den)
    db = abs(r.num * b.den * a.den - b.num * r.den * a.den)
    return a if da <= db else b


@dataclass
class FitConfig:
    width: int                      # active resolution
    height: int
    fit_mode: str = FIT_FIT
    display_aspect_ratios: tuple = (Rational(4, 3),)
    min_display_aspect_ratio: Rational | None = None
    max_display_aspect_ratio: Rational | None = None


def calculate_frame_size(cfg: FitConfig, resolution: Rational,
                         aspect: Rational | None) -> tuple[int, int]:
    """Visible (width, height) of the source inside the active frame
    (src/av.c:103-220).  Returned as a plain (w, h) tuple — NOT a
    Rational, which would reduce the pair by their gcd."""
    r_num, r_den = cfg.width, cfg.height

    if cfg.fit_mode == FIT_STRETCH:
        pass
    elif cfg.fit_mode == FIT_NONE:
        return resolution.num, resolution.den
    else:
        if aspect is None or aspect.num <= 0 or aspect.den <= 0:
            aspect = resolution
        if cfg.fit_mode == FIT_FILL:
            c = cfg.display_aspect_ratios[0]
            if len(cfg.display_aspect_ratios) > 1:
                c = _nearest(aspect, c, cfg.display_aspect_ratios[1])
        else:
            c = aspect
        if (cfg.min_display_aspect_ratio is not None
                and _cmp(c, cfg.min_display_aspect_ratio) < 0):
            c = cfg.min_display_aspect_ratio
        if (cfg.max_display_aspect_ratio is not None
                and _cmp(c, cfg.max_display_aspect_ratio) > 0):
            c = cfg.max_display_aspect_ratio

        b = cfg.display_aspect_ratios[0]
        if len(cfg.display_aspect_ratios) > 1:
            b = _nearest(c, b, cfg.display_aspect_ratios[1])

        if _cmp(c, b) > 0:      # letterbox
            r_den = r_den * (b.num * c.den) // (b.den * c.num)
        elif _cmp(c, b) < 0:    # pillarbox
            r_num = r_num * (c.num * b.den) // (c.den * b.num)

        if _cmp(c, aspect) > 0:     # vertical crop
            r_den = r_den * (c.num * aspect.den) // (c.den * aspect.num)
        elif _cmp(c, aspect) < 0:   # horizontal crop
            r_num = r_num * (aspect.num * c.den) // (aspect.den * c.num)

    for (rn, rd), (fn, fd) in _FADJ:
        if resolution.num == rn and resolution.den == rd:
            r_num = r_num * fn // fd
            break
    return max(r_num, 1), max(r_den, 1)


def _cmp(a: Rational, b: Rational) -> int:
    d = a.num * b.den - b.num * a.den
    return (d > 0) - (d < 0)


def display_aspect_ratio(width: int, height: int,
                         par: Rational) -> Rational:
    """DAR = SAR * PAR (src/av.c:225-233)."""
    return Rational(width * par.num, height * par.den)


# -- orientation ops (src/av.c:242-303): O(1) numpy views ---------------
def hflip(rgb: np.ndarray) -> np.ndarray:
    return rgb[:, ::-1]


def vflip(rgb: np.ndarray) -> np.ndarray:
    return rgb[::-1]


def rotate(rgb: np.ndarray, a: int) -> np.ndarray:
    a %= 4
    if a in (1, 3):
        rgb = np.swapaxes(rgb[::-1], 0, 1)
    if a in (2, 3):
        rgb = rgb[::-1, ::-1]
    return rgb


def crop(rgb: np.ndarray, x: int, y: int, width: int,
         height: int) -> np.ndarray:
    if x < 0:
        width += x
        x = 0
    if y < 0:
        height += y
        y = 0
    h, w = rgb.shape[:2]
    width = min(width, w - x)
    height = min(height, h - y)
    return rgb[y:y + height, x:x + width]


def scale_nearest(rgb: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nearest-neighbour rescale (the raster's own source-pixel mapping
    uses the same integer math, src/video.c:2972)."""
    h, w = rgb.shape[:2]
    ys = (np.arange(height) * h) // height
    xs = (np.arange(width) * w) // width
    return rgb[ys][:, xs]


class FitSource:
    """Wrap an AV source so it presents exactly the active resolution,
    applying the fit mode with black borders (letterbox/pillarbox) and
    optional flip/rotate, like the reference's scaler thread
    (src/av_ffmpeg.c:550-753)."""

    def __init__(self, inner, cfg: FitConfig, rotate_a: int = 0,
                 do_hflip: bool = False, do_vflip: bool = False,
                 par: Rational | None = None):
        self.inner = inner
        self.cfg = cfg
        self.rotate_a = rotate_a
        self.do_hflip = do_hflip
        self.do_vflip = do_vflip
        self.par = par or Rational(1, 1)
        self.width = cfg.width
        self.height = cfg.height
        self.interlaced = getattr(inner, "interlaced", 0)
        self._cache: tuple[int, np.ndarray] | None = None
        # PAR of the fitted output frame (consumed by the MAC aspect
        # flag, src/mac.c:893-897): the chosen display ratio over the
        # active-frame SAR; updated per frame in read_video
        from fractions import Fraction as _F
        b = cfg.display_aspect_ratios[0]
        self.pixel_aspect_ratio = _F(b.num * cfg.height,
                                     b.den * cfg.width)

    def read_video(self, frame_no: int) -> np.ndarray:
        if self._cache is not None and self._cache[0] == frame_no:
            return self._cache[1]
        rgb = self.inner.read_video(frame_no)
        if self.rotate_a:
            rgb = rotate(rgb, self.rotate_a)
        if self.do_hflip:
            rgb = hflip(rgb)
        if self.do_vflip:
            rgb = vflip(rgb)
        h, w = rgb.shape[:2]
        dar = display_aspect_ratio(w, h, self.par)
        if len(self.cfg.display_aspect_ratios) > 1:
            from fractions import Fraction as _F
            b = _nearest(dar, *self.cfg.display_aspect_ratios[:2])
            self.pixel_aspect_ratio = _F(b.num * self.cfg.height,
                                         b.den * self.cfg.width)
        vis_w, vis_h = calculate_frame_size(self.cfg, Rational(w, h), dar)
        vw = min(int(vis_w), self.cfg.width)
        vh = min(int(vis_h), self.cfg.height)
        scaled = scale_nearest(rgb, vw, vh)
        out = np.zeros((self.cfg.height, self.cfg.width, 3), dtype=np.uint8)
        y0 = (self.cfg.height - vh) // 2
        x0 = (self.cfg.width - vw) // 2
        out[y0:y0 + vh, x0:x0 + vw] = scaled
        self._cache = (frame_no, out)
        return out

    def read_audio(self, start: int, count: int) -> np.ndarray:
        return self.inner.read_audio(start, count)

    def read_cc608(self, frame_no: int):
        f = getattr(self.inner, "read_cc608", None)
        return f(frame_no) if f is not None else (0, 0)

    def eof(self, frame_no: int) -> bool:
        return self.inner.eof(frame_no)
