"""ACP / Macrovision-style copy protection (src/acp.c; port of
hacktv_tpu/services/acp.py): six P-Sync + AGC pulse pairs on 10 (625) or
8 (525) VBI lines per field, with the AGC level cycling as a clipped
sawtooth over frames."""

from __future__ import annotations

import numpy as np
import torch


class ACP:
    STATICS = ("psync_mask", "pagc_mask")

    def __init__(self, params, device="cuda"):
        p = params
        if p.conf.lines == 625:
            left, spacing, psync_w = 8.88e-6, 5.92e-6, 2.368e-6
            self.line_ranges = ((9, 18), (321, 330))
        else:
            left, spacing, psync_w = 8.288e-6, 8.288e-6, 2.222e-6
            self.line_ranges = ((12, 19), (275, 282))
        self.psync_level = p.sync_level + round(
            (p.white_level - p.sync_level) * 0.06)
        self.psync_width = round(p.pixel_rate * psync_w)
        self.pagc_width = round(p.pixel_rate * 2.7e-6)
        self.lefts = [round(p.pixel_rate * (left + spacing * i))
                      for i in range(6)]
        self.lines_total = p.conf.lines
        self.width = p.width
        self.sync_level = p.sync_level
        self.params = p

        # pulse-position masks (static)
        cols = np.arange(p.width)
        psync = np.zeros(p.width, dtype=bool)
        pagc = np.zeros(p.width, dtype=bool)
        for lx in self.lefts:
            psync |= (cols >= lx) & (cols < lx + self.psync_width)
            pagc |= (cols >= lx + self.psync_width) & \
                    (cols < lx + self.psync_width + self.pagc_width)
        self.psync_mask = psync.astype(np.float32)
        self.pagc_mask = pagc.astype(np.float32)
        self.device = torch.device(device)
        self.upload()

    def upload(self):
        """The pulse masks on the device."""
        self.d_psync = torch.as_tensor(self.psync_mask, device=self.device)
        self.d_pagc = torch.as_tensor(self.pagc_mask, device=self.device)

    def _agc_level(self, frame: int) -> int:
        """Clipped sawtooth over frames (src/acp.c:80-91), passed through
        the grey-level video LUT."""
        i = abs(frame * 4 % 1712 - 856) - 150
        i = min(max(i, 0), 255)
        # yuv_level_lookup[grey].y
        p = self.params
        conf = p.conf
        g = (i / 255.0) ** (1.0 / p.gamma)
        y = g * (p.rw_co + p.gw_co + p.bw_co)
        yl = (conf.black_level + y * (conf.white_level - conf.black_level)) \
            * p.level
        yq = round(float(np.clip(yl, -1, 1)) * 32767)
        return self.sync_level + round((yq - self.sync_level) * 1.10)

    def block_arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        active = np.zeros(nlines, dtype=np.float32)
        agc = np.zeros(nlines, dtype=np.float32)
        ks = k0 + np.arange(nlines, dtype=np.int64)
        lines = ks % self.lines_total + 1
        frames = 1 + ks // self.lines_total
        on = np.zeros(nlines, dtype=bool)
        for lo, hi in self.line_ranges:
            on |= (lines >= lo) & (lines <= hi)
        on &= ks >= 0
        if claimed is not None:
            on &= ~np.asarray(claimed[:nlines], dtype=bool)
        idx = np.nonzero(on)[0]
        if len(idx):
            active[idx] = 1.0
            uf, inv = np.unique(frames[idx], return_inverse=True)
            lv = np.array([self._agc_level(int(f)) for f in uf],
                          dtype=np.float32)
            agc[idx] = lv[inv]
            if claimed is not None:
                claimed[idx] = True
        return {"active": active, "agc": agc}

    def apply(self, out, arrays, lut=None):
        act = arrays["active"][:, None]
        ps = self.d_psync[None, :] * act
        pa = self.d_pagc[None, :] * act
        out = out * (1.0 - ps) + ps * float(self.psync_level)
        out = out * (1.0 - pa) + pa * arrays["agc"][:, None]
        return out
