"""SECAM chrominance as hacktv's serial line process computes it
(src/video.c:3068-3233, set up at :4075-4162; the IIR of src/fir.c:
710-740), written plainly in torch: the rows of a block side by side,
each stage a loop over the line's samples where the process is serial.

  - line-alternating D'r/D'b from the source's U/V rows, averaged with
    the previous line of the same field (C's truncating `/ 2`; the
    buffer is cleared at lines 1 and 313);
  - the 15-tap Q15 chroma low-pass, int32 accumulate >> 15, zero edges;
  - the HF pre-emphasis IIR y = x b0 + x[-1] b1 - y[-1] a1 in float64,
    its state carried from one active line to the next, llround;
  - the deviation clamps (D'b and D'r each their own);
  - the FM carrier: an int32 phasor reset to +-INT32_MAX at each line's
    burst start (inverted on every third line) and stepped through the
    quantised per-chroma-value LUT with >> 31, then
    ((((p >> 16) * level) >> 15) * bell) >> 15, the bell gain from the
    65,536-entry LUT, and the burst window's envelope >> 15;
  - the luma band-reject (51 Q15 taps with a 0.5 bypass) over the
    active segment, from zero history at its start.

The IIR's pole is 0.90456: over one 1,024-sample line its start state
decays by 0.90456^1024, about 1e-45, far below float64's resolution, so a
line's end state does not depend on its start.  The rows of a block run
side by side on that fact: a first pass from zero gives every row's end
state, a second pass starts each row from the end state of the active
row before it.  A block's first row starts from the end of the last
active line before it, which the first pass computes too; nothing is
read from the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference.codec.config.standards import (SECAM_CB_FREQ, SECAM_CR_FREQ,
                                              SECAM_FM_DEV, SECAM_FM_FREQ)
from reference.codec.ops import firdes
from reference.codec.ops.shapes import IRT1090, rc_window
from reference.codec.video import sequence

INT16_MAX = 32767
INT32_MAX = 2147483647
IIR_B = (2.90456054, -2.80912108)     # src/video.c:4087-4090
IIR_A1 = -0.90456054


def lround(x):
    """C's lround, half away from zero, of a float64 numpy array or
    tensor (x - trunc(x) is exact, so the tie test is too)."""
    lib = torch if isinstance(x, torch.Tensor) else np
    t = lib.trunc(x)
    return t + lib.sign(x) * (lib.abs(x - t) >= 0.5)


class SecamLine:
    """The line process's constants (src/video.c:4075-4162) for video
    parameters `p` (reference/codec/video/params.py) and a source
    `frame_w` columns wide placed `vframe_x` columns into the active
    area."""

    def __init__(self, p, vframe_x: int, frame_w: int, vframe_y: int,
                 frame_h: int, device):
        conf = p.conf
        self.conf, self.W = conf, p.width
        self.active_left, self.active_width = p.active_left, p.active_width
        self.half_width = p.half_width
        self.col0, self.frame_w = p.active_left + vframe_x, frame_w
        self.vframe_y, self.frame_h = vframe_y, frame_h
        # luma band-reject around the subcarrier, plus a 0.5 bypass,
        # renormalised (src/video.c:4100-4107)
        taps = firdes.band_reject(51, p.pixel_rate, SECAM_FM_FREQ - 1e6,
                                  SECAM_FM_FREQ + 1e6, 1e6, 1.0)
        taps[51 // 2] += 0.5
        taps = taps / taps.sum()
        self.luma_q = lround(taps * INT16_MAX).astype(np.int64)
        self.chroma_q = lround(firdes.low_pass(
            15, p.pixel_rate, 1.70e6, 0.50e6, 1.0) * INT16_MAX
        ).astype(np.int64)
        # the deviation clamps, (D'b, D'r)
        q = lambda f: round((f - SECAM_FM_FREQ) / SECAM_FM_DEV * INT16_MAX)
        self.dmin = (q(SECAM_CB_FREQ - 350e3), q(SECAM_CR_FREQ - 506e3))
        self.dmax = (q(SECAM_CB_FREQ + 506e3), q(SECAM_CR_FREQ + 350e3))
        # the chroma of black (the RGB 0 entry of the conversion table)
        self.black = tuple(round(np.clip((f - SECAM_FM_FREQ) / SECAM_FM_DEV,
                                         -1, 1) * INT16_MAX)
                           for f in (SECAM_CB_FREQ, SECAM_CR_FREQ))
        secam_level = (conf.white_level - conf.blanking_level) * p.level
        self.level = int(round(INT16_MAX * secam_level))
        # the carrier's span and envelope (src/video.c:4139-4147)
        rise = conf.burst_rise * IRT1090
        self.sl = round(p.pixel_rate * (conf.burst_left - conf.burst_rise / 2))
        self.blen = math.ceil(p.pixel_rate * (conf.burst_width + rise))
        t = np.arange(self.blen) / p.pixel_rate
        self.win = np.round(rc_window(t, rise / 2, conf.burst_width, rise)
                            * INT16_MAX).astype(np.int64)
        # per chroma value (index c + 32768): the phasor step, quantised
        # to int32 (src/video.c:2234-2240), and the bell gain's two
        # components, quantised to int16 (src/video.c:2172-2185)
        r = np.arange(-32768, 32768, dtype=np.float64)
        d = 2.0 * np.pi / p.pixel_rate * (SECAM_FM_FREQ
                                          + r * SECAM_FM_DEV / INT16_MAX)
        f = SECAM_FM_FREQ + r * SECAM_FM_DEV / INT16_MAX
        ff = f / 4.286e6 - 4.286e6 / f
        lq, rq = 16.0 * ff, 1.26 * ff
        den = 1.0 + rq * rq
        t64 = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
        self.step_i = t64(lround(np.cos(d) * INT32_MAX))
        self.step_q = t64(lround(np.sin(d) * INT32_MAX))
        self.bell_i = t64(lround(0.115 * (1.0 + lq * rq) / den * INT16_MAX))
        self.bell_q = t64(lround(0.115 * (lq - rq) / den * INT16_MAX))

    # -- the line counters --------------------------------------------
    def line(self, k: int) -> dict:
        """What the process knows of stream line k (k = 0 is frame 1,
        line 1): active or not, half a line only, D'r or D'b, the
        carrier's initial sign, and the source rows it averages."""
        conf = self.conf
        k = max(k, 0)
        line, frame = k % conf.lines + 1, 1 + k // conf.lines
        code = sequence.line_sequence(conf.type, line)
        n = frame * conf.lines + line
        out = {"active": code[2] == "a" or code[3] == "a",
               "half": code[3] != "a", "dr": n & 1,
               "sign": 1 if n % 3 == 0 else -1,
               "vy": self._source_row(line), "vy_prev": None}
        if out["active"] and k > 0 and line not in (1, (conf.lines + 1) // 2):
            pline = (k - 1) % conf.lines + 1
            pcode = sequence.line_sequence(conf.type, pline)
            if pcode[2] == "a" or pcode[3] == "a":
                out["vy_prev"] = self._source_row(pline)
        return out

    def _source_row(self, line: int) -> int:
        v = sequence.active_video_line(self.conf.type, line)
        if v >= 0 and self.conf.interlaced:
            v += 1          # a progressive source on an interlaced raster
        v -= self.vframe_y
        return v if 0 <= v < self.frame_h else -1

    # -- the chroma baseband ------------------------------------------
    def chroma_fir(self, infos: list, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
        """The low-passed chroma line, int64 [len(infos), W], of each
        line's info (`line`): the averaged D'r or D'b row on the black
        level, through the Q15 FIR."""
        W, H = self.W, u.shape[0]
        dev = u.device
        # the source rows by index: U's, black D'b, V's, black D'r, and a
        # cleared row
        full = lambda val: torch.full_like(u[:1], val)
        planes = torch.cat([u, full(self.black[0]), v, full(self.black[1]),
                            full(0.0)])
        at = lambda y, dr: (y if 0 <= y < H else H) + dr * (H + 1)
        cur = [at(i["vy"], i["dr"]) for i in infos]
        prv = [2 * H + 2 if i["vy_prev"] is None else
               at(i["vy_prev"], i["dr"]) for i in infos]
        idx = lambda a: torch.tensor(a, dtype=torch.int64, device=dev)
        avg = torch.trunc((planes[idx(cur)] + planes[idx(prv)]) / 2)
        black = idx([self.black[i["dr"]] for i in infos])
        rows = black[:, None].repeat(1, W)
        n = min(self.frame_w, W - self.col0)
        rows[:, self.col0:self.col0 + n] = avg[:, :n].to(torch.int64)
        return fir_q15(rows, self.chroma_q)

    def iir(self, x: torch.Tensor, start: torch.Tensor | None):
        """The pre-emphasis IIR over each row of x (int64 [R, W]) on its
        own, from `start` (float64 [R, 2]: the last input and output
        before the row) or from zero: the rows' llround-ed, clamped
        outputs int64 [R, W] and their end states float64 [R, 2]."""
        R, W = x.shape
        xf = x.to(torch.float64)
        ix = torch.zeros(R, dtype=torch.float64, device=x.device)
        iy = torch.zeros_like(ix)
        if start is not None:
            ix, iy = start[:, 0].clone(), start[:, 1].clone()
        y = torch.empty((R, W), dtype=torch.float64, device=x.device)
        b0, b1 = IIR_B
        for i in range(W):
            xi = xf[:, i]
            iy = xi * b0 + ix * b1 - iy * IIR_A1
            ix = xi
            y[:, i] = iy
        yq = lround(torch.clamp(y, -32768.0, 32767.0)).to(torch.int64)
        return yq, torch.stack([ix, iy], dim=1)

    def clamp(self, y: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
        """The deviation clamps of D'b rows (dr 0) and D'r rows (dr 1)."""
        lo = torch.where(dr > 0, self.dmin[1], self.dmin[0])[:, None]
        hi = torch.where(dr > 0, self.dmax[1], self.dmax[0])[:, None]
        return torch.minimum(torch.maximum(y, lo), hi)

    # -- the FM carrier -----------------------------------------------
    def carrier(self, c: torch.Tensor, infos: list) -> torch.Tensor:
        """The chroma carrier's add-in, int64 [R, W], of the clamped
        chroma c (int64 [R, W]) of active lines `infos`."""
        R, W = c.shape
        dev = c.device
        sl = self.sl
        end = torch.tensor([self.half_width if i["half"]
                            else min(sl + self.blen, W) for i in infos],
                           dtype=torch.int64, device=dev)
        pi = torch.tensor([i["sign"] * INT32_MAX for i in infos],
                          dtype=torch.int64, device=dev)
        pq = torch.zeros_like(pi)
        out = torch.zeros((R, W), dtype=torch.int64, device=dev)
        for x in range(sl, int(end.max()) if R else sl):
            e = c[:, x] + 32768
            li, lq = self.step_i[e], self.step_q[e]
            pi, pq = (pi * li - pq * lq) >> 31, (pi * lq + pq * li) >> 31
            vi = ((pi >> 16) * self.level) >> 15
            vq = ((pq >> 16) * self.level) >> 15
            m = ((vi * self.bell_i[e]) >> 15) - ((vq * self.bell_q[e]) >> 15)
            o = (m * int(self.win[x - sl])) >> 15
            out[:, x] = torch.where(x < end, o, 0)
        return out

    # -- the luma -----------------------------------------------------
    def luma(self, y: torch.Tensor) -> torch.Tensor:
        """The band-rejected luma of rows y (float [R, W]), int64: the
        FIR over the row from the active segment's start on (zero
        history there, the real samples past its end)."""
        cols = torch.arange(self.W, device=y.device)
        x = torch.where(cols >= self.active_left, y.to(torch.int64), 0)
        return fir_q15(x, self.luma_q)


def fir_q15(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """A Q15 FIR over each row of x (int64 [R, W]) with zero edges:
    out[i] = (sum_k x[k] taps[i + h - k]) >> 15, saturated to int16
    (src/fir.c:342-346; every sum here fits the reference's int32)."""
    R, W = x.shape
    nt = len(taps)
    h = nt // 2
    xp = F.pad(x, (h, h))
    acc = torch.zeros_like(x)
    for t in range(nt):
        acc += int(taps[nt - 1 - t]) * xp[:, t:t + W]
    return torch.clamp(acc >> 15, -32768, 32767)
