"""Widescreen Signalling (ETSI EN 300 294) on line 23 (port of
hacktv_tpu/services/wss.py).

Batch re-implementation of src/wss.c: 137-symbol NRZ burst at 5 MHz
biphase group coding, flat-top 200 ns pulses starting 11 us into line 23,
with 42.5 us blanked from the half-line point so the bits never overlap
active video.
"""

from __future__ import annotations

import numpy as np
import torch

from ..rational import Rational
from . import vbidata

MODES = {
    # name: (parity|code, frame aspects)
    "4:3":             (0x08 | 0x00, (Rational(4, 3),)),
    "14:9-letterbox":  (0x00 | 0x01, (Rational(4, 3),)),
    "14:9-top":        (0x00 | 0x02, (Rational(4, 3),)),
    "16:9-letterbox":  (0x08 | 0x03, (Rational(4, 3),)),
    "16:9-top":        (0x00 | 0x04, (Rational(4, 3),)),
    "16:9+-letterbox": (0x08 | 0x05, (Rational(4, 3),)),
    "14:9-window":     (0x08 | 0x06, (Rational(4, 3),)),
    "16:9":            (0x00 | 0x07, (Rational(16, 9),)),
    "auto":            (0xFF, (Rational(4, 3), Rational(16, 9))),
}

_RUN_IN = bytes([0xF8, 0xE3, 0x8E, 0x38, 0xF1, 0xE0, 0xF8])


def _group_bits(vbi: bytearray, code: int, offset: int, length: int) -> int:
    """Biphase group coding (src/wss.c:47-67)."""
    for _ in range(length):
        for i in range(6):
            if i == 3:
                code ^= 1
            b = 7 - (offset % 8)
            vbi[offset // 8] &= ~(1 << b)
            vbi[offset // 8] |= (code & 1) << b
            offset += 1
        code >>= 1
    return offset


def wss_vbi_bytes(code: int) -> bytes:
    vbi = bytearray(18)
    vbi[:7] = _RUN_IN
    o = _group_bits(vbi, code, 29 + 24, 4)   # group 1: aspect ratio
    o = _group_bits(vbi, 0x00, o, 4)         # group 2: enhanced services
    o = _group_bits(vbi, 0x00, o, 3)         # group 3: subtitles
    o = _group_bits(vbi, 0x00, o, 3)         # group 4: reserved
    return bytes(vbi)


class WSS:
    """Per-block WSS arrays for the batch encoder."""

    STATICS = ("basis", "bits")
    _CKPT_ATTRS = ("bits",)
    # block arrays that are not per row (services.window_arrays)
    block_keys = ("wave",)

    def __init__(self, params, mode: str, device="cuda"):
        try:
            self.code, self.aspects = MODES[mode]
        except KeyError:
            raise ValueError(f"wss: unrecognised mode {mode!r}") from None
        p = params
        level = round((p.white_level - p.black_level) * (5.0 / 7.0))
        self.basis = vbidata.basis_step(
            137, p.width, level,
            p.pixel_rate * 200e-9, p.pixel_rate * 200e-9,
            p.pixel_rate * 11e-6)
        self.nbits = 137
        self.line = 23
        self.lines_total = p.conf.lines
        self.half_width = p.half_width
        self.blank_width = round(p.pixel_rate * 42.5e-6)
        self.black_level = float(p.black_level)
        self.device = torch.device(device)

        code = self.code if self.code != 0xFF else 0x08  # auto: 4:3 default
        self.bits = vbidata.bytes_to_bits(wss_vbi_bytes(code), 137,
                                          lsb_first=False)
        self.upload()

    def upload(self):
        """The blanking mask on the device."""
        cols = torch.arange(self.basis.shape[1], device=self.device)
        self.d_blank = ((cols >= self.half_width)
                        & (cols < self.blank_width)).to(torch.float32)

    def set_auto_aspect(self, widescreen: bool):
        if self.code == 0xFF:
            self.bits = vbidata.bytes_to_bits(
                wss_vbi_bytes(0x07 if widescreen else 0x08), 137,
                lsb_first=False)

    def block_arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        """The active flag per line (line 23 of each frame) and the
        waveform row: every active line carries the same (current) code,
        so only the mask and one row travel."""
        ks = np.arange(k0, k0 + nlines, dtype=np.int64)
        line = np.where(ks >= 0, ks % self.lines_total + 1, 0)
        active = (line == self.line)
        if claimed is not None:
            claimed |= active
        return {"active": active.astype(np.float32),
                "wave": (self.bits @ self.basis).astype(np.float32)}

    def apply(self, out, arrays, lut=None):
        """Device: blank [half_width, blank_width) to black on active
        lines, then add the waveform row."""
        act = arrays["active"][:, None]
        blank = self.d_blank[None, :] * act
        out = out * (1.0 - blank) + blank * self.black_level
        return out + act * arrays["wave"][None, :]
