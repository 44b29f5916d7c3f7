"""VITS insertion test signals (src/vits.c; port of
hacktv_tpu/services/vits.py).

Four (625) or two (525) reference lines are pre-rendered analytically at
init — sin^2 pulses, rc-window staircases, multiburst packets — exactly as
the reference computes them, including its int16 rounding.  The chroma
part mixes against the line's colour carrier at a fixed phase (60 deg PAL,
180 deg NTSC) at render time.
"""

from __future__ import annotations

import numpy as np
import torch

from ..audio.synth import fma32
from ..ops.shapes import rc_window

_BURSTS_625 = [0.5e6, 1.0e6, 2.0e6, 4.0e6, 4.8e6, 5.8e6]
_BURSTS_525 = [0.5e6, 1.0e6, 2.0e6, 3.0e6, 3.58e6, 4.2e6]


def _pulse(t, position, width, amplitude):
    t = t - (position - width)
    out = np.zeros_like(t)
    m = (t > 0) & (t < width * 2)
    out[m] = np.power(np.sin(t[m] / (width * 2) * np.pi), 2) * amplitude
    return out


def _templates_625(width: int, level: int):
    ts_line = 1.0 / 25 / 625
    h = ts_line / 32
    t = np.arange(width) * (ts_line / width)
    rc = rc_window
    out = []
    for i in range(4):
        r = np.zeros(width)
        c = np.zeros(width)
        if i == 0:      # line 17
            r += rc(t, 6 * h, 5 * h, 200e-9) * 0.70
            r += _pulse(t, 13 * h, 200e-9, 0.70)
            r += _pulse(t, 16 * h, 2000e-9, 0.70 / 2)
            c += _pulse(t, 16 * h, 2000e-9, 0.70 / 2)
            for k, a in enumerate([0.14, 0.28, 0.42, 0.56]):
                r += rc(t, (20 + 2 * k) * h, 2 * h, 200e-9) * a
            r += rc(t, 28 * h, 3 * h, 200e-9) * 0.70
        elif i == 1:    # line 18
            r += rc(t, 6 * h, 25 * h, 200e-9) * 0.35
            r += rc(t, 6 * h, 2 * h, 200e-9) * 0.21
            r += rc(t, 8 * h, 2 * h, 200e-9) * -0.21
            for b, f in enumerate(_BURSTS_625):
                r += (rc(t, (12 + 3 * b) * h, 2 * h, 200e-9) * 0.21
                      * np.sin((t - (12 + 3 * b) * h) * 2 * np.pi * f))
        elif i == 2:    # line 330
            r += rc(t, 6 * h, 5 * h, 200e-9) * 0.70
            r += _pulse(t, 13 * h, 200e-9, 0.70)
            c += rc(t, 15 * h, 15 * h, 1e-6) * 0.28 / 2
            for k, a in enumerate([0.14, 0.28, 0.42, 0.56]):
                r += rc(t, (20 + 2 * k) * h, 2 * h, 200e-9) * a
            r += rc(t, 28 * h, 3 * h, 200e-9) * 0.70
        else:           # line 331
            r += rc(t, 6 * h, 25 * h, 200e-9) * 0.35
            c += rc(t, 7 * h, 7 * h, 1e-6) * 0.70 / 2
            c += rc(t, 17 * h, 13 * h, 1e-6) * 0.42 / 2
        out.append((np.round(r / 0.7 * level), np.round(c / 0.7 * level)))
    return out


def _templates_525(width: int, level: int):
    ts_line = 1001.0 / 30000 / 525
    h = ts_line / 128
    t = np.arange(width) * (ts_line / width)
    rc = rc_window
    out = []
    for i in range(2):
        r = np.zeros(width)
        c = np.zeros(width)
        if i == 0:      # line 17
            r += rc(t, 24 * h, 36 * h, 125e-9) * 100
            r += _pulse(t, 68 * h, 250e-9, 100)
            r += _pulse(t, 75 * h, 1570e-9, 100 / 2)
            c += _pulse(t, 75 * h, 1570e-9, 100 / 2)
            for k, a in enumerate([18, 36, 54, 72]):
                r += rc(t, (92 + 6 * k) * h, 6 * h, 250e-9) * a
            r += rc(t, 116 * h, 8 * h, 250e-9) * 90
            c += rc(t, 84 * h, 38 * h, 400e-9) * 40 / 2
        else:           # line 280
            r += rc(t, 24 * h, 8 * h, 125e-9) * 100
            r += rc(t, 32 * h, 92 * h, 125e-9) * 50
            r += (rc(t, 36 * h, 12 * h, 250e-9) * 50 / 2
                  * np.sin((t - 36 * h) * 2 * np.pi * _BURSTS_525[0]))
            for b in range(1, 6):
                r += (rc(t, (40 + 8 * b) * h, 8 * h, 250e-9) * 50 / 2
                      * np.sin((t - (40 + 8 * b) * h) * 2 * np.pi
                               * _BURSTS_525[b]))
            c += rc(t, 92 * h, 8 * h, 400e-9) * 20 / 2
            c += rc(t, 100 * h, 8 * h, 400e-9) * 40 / 2
            c += rc(t, 108 * h, 12 * h, 400e-9) * 80 / 2
        out.append((np.round(r / 100 * level), np.round(c / 100 * level)))
    return out


class VITS:
    STATICS = ("r_tpl", "c_tpl", "cs")

    def __init__(self, params, pal: bool, *, fused_mix: bool,
                 device="cuda"):
        p = params
        level = p.white_level - p.blanking_level
        self.lines_total = p.conf.lines
        if p.conf.lines == 625:
            tpl = _templates_625(p.width, level)
            self.line_map = {17: 0, 18: 1, 330: 2, 331: 3}
        elif p.conf.lines == 525:
            tpl = _templates_525(p.width, level)
            self.line_map = {17: 0, 280: 1}
        else:
            raise ValueError("vits: unsupported line count")
        self.r_tpl = np.stack([np.concatenate([np.zeros(p.width)])] +
                              [a[0] for a in tpl]).astype(np.float32)
        self.c_tpl = np.stack([np.zeros(p.width)] +
                              [a[1] for a in tpl]).astype(np.float32)
        # chroma phase against the line's carrier LUT: 60 deg from +(B-Y)
        # for PAL; NTSC uses the burst phase constant {0, -INT16_MAX}
        # exactly as the reference does (src/vits.c:245-258)
        if pal:
            ph = 60.0 * np.pi / 180.0
            self.cs = (round(np.cos(ph) * 32767), round(np.sin(ph) * 32767))
        else:
            self.cs = (0, -32767)
        self.colour = params.cl_num > 0
        # how XLA's CPU step contracts the chroma mix: with the exact
        # carrier rows it fuses the cs.q product into the add; with the
        # angle-addition carrier it rounds both products (see apply).
        # No default: the wrong one is 1 LSB off on some lines
        self.fused_mix = fused_mix
        a = np.zeros(self.lines_total + 1, dtype=np.int32)
        for line, t in self.line_map.items():
            a[line] = t + 1
        self._lmap_arr = a
        self.device = torch.device(device)
        self.upload()

    def upload(self):
        """The templates on the device."""
        self.d_r_tpl = torch.as_tensor(self.r_tpl, device=self.device)
        self.d_c_tpl = torch.as_tensor(self.c_tpl, device=self.device)

    def block_arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        ks = k0 + np.arange(nlines, dtype=np.int64)
        idx = self._lmap_arr[ks % self.lines_total + 1]
        idx[ks < 0] = 0
        if claimed is not None:
            claimed[np.nonzero(idx)[0]] = True
        return {"idx": idx}

    def apply(self, out, arrays, lut=None):
        """out [B, W]; lut: per-line carrier ([B, W] cos, [B, W] sin)
        tuple or None (src/vits.c:286-301)."""
        idx = arrays["idx"].long()
        out = out + self.d_r_tpl[idx]
        if self.colour and lut is not None:
            c = self.d_c_tpl[idx]
            inv = 1.0 / 32768.0
            # (cs.i * lut.q + cs.q * lut.i) >> 15, then * c >> 15; the
            # products scale by 2^-15 exactly, so (cs * lut) * inv is
            # lut * (cs * inv)
            if self.fused_mix:
                mix = torch.floor(fma32(lut[0], self.cs[1] * inv,
                                        lut[1] * (self.cs[0] * inv)))
            else:
                mix = torch.floor(float(self.cs[0]) * lut[1] * inv
                                  + float(self.cs[1]) * lut[0] * inv)
            out = out + torch.floor(mix * c * inv)
        return out
