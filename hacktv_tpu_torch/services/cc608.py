"""CEA/EIA-608 closed captions on line 21/22 (src/cc608.c; port of
hacktv_tpu/services/cc608.py): 7-cycle clock run-in + start bit + two
odd-parity characters."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.shapes import IRT1090
from . import vbidata


def encode_chars(c1: int, c2: int) -> bytes:
    """Start bit + odd-parity char pair -> 17 bits (src/cc608.c:172-188)."""
    def parity(c):
        c = (c & 0x7F) | 0x80
        for i in range(1, 8):
            c ^= (c << i) & 0x80
        return c
    c1 = parity(c1)
    c2 = parity(c2)
    data = bytes([((c1 << 1) | 0x01) & 0xFF,
                  ((c2 << 1) | (c1 >> 7)) & 0xFF,
                  (c2 >> 7) & 0xFF])
    return data


class CC608:
    STATICS = ("basis", "cri")
    # what a checkpoint carries (Encoder.checkpoint)
    _CKPT_ATTRS = ("fifo", "_cc_frame")

    def __init__(self, params, source=None, device="cuda"):
        p = params
        from ..config.standards import RasterType
        if p.conf.type == RasterType.RASTER_525:
            self.line = 21
            offset = 27.382e-6
        elif p.conf.type == RasterType.RASTER_625:
            self.line = 22
            offset = 27.5e-6
        else:
            raise ValueError("cc608: unsupported TV mode")
        level = round((p.white_level - p.black_level) * 0.5)
        self.basis = vbidata.basis_step(
            32, p.width, level, p.width / 32,
            p.pixel_rate * 240e-9 * IRT1090, p.pixel_rate * offset)
        # clock run-in: 7 cycles raised-sine (src/cc608.c:141-154)
        w = p.width * 7 / 32
        x = p.pixel_rate * offset - (p.width * 8.75 / 32)
        self.cri_x = int(x)
        cri_len = math.ceil(w)
        i = np.arange(cri_len)
        # int16 assignment truncates toward zero in C
        self.cri = np.trunc(
            (0.5 - np.cos((i - (x - self.cri_x)) * (2 * np.pi / w * 7)) * 0.5)
            * level).astype(np.float32)
        self.lines_total = p.conf.lines
        self.width = p.width
        self.fifo: list[tuple[int, int]] = []
        # per-frame caption side data from the AV source (the reference
        # pushes the frame's A53 byte pair into the fifo at the frame
        # hand-off, src/video.c:4899-4903, src/av_ffmpeg.c:566-581)
        self.source = source
        self._cc_frame = 0
        self.device = torch.device(device)
        self.upload()

    def upload(self):
        """The basis and the clock run-in row on the device.  The run-in
        starts at cri_x, clamped so that it fits the line, as XLA's
        dynamic_update_slice clamps its start."""
        self.d_basis = torch.as_tensor(self.basis, device=self.device)
        row = torch.zeros(self.width, dtype=torch.float32)
        n = len(self.cri)
        x0 = min(max(self.cri_x, 0), self.width - n)
        row[x0:x0 + n] = torch.as_tensor(self.cri)
        self.d_cri = row.to(self.device)

    def write_pair(self, c1: int, c2: int):
        if (c1 | c2) & 0x7F:
            self.fifo.append((c1, c2))

    def block_arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        ks = k0 + np.arange(nlines, dtype=np.int64)
        line = np.where(ks >= 0, ks % self.lines_total + 1, 0)
        packed = np.zeros((nlines, 4), dtype=np.uint8)
        active = np.zeros(nlines, dtype=np.float32)
        pull = getattr(self.source, "read_cc608", None)
        for b in np.nonzero(line == self.line)[0]:
            b = int(b)
            k = int(ks[b])
            frame = 1 + k // self.lines_total
            if pull is not None and frame > self._cc_frame:
                for f in range(self._cc_frame + 1, frame + 1):
                    self.write_pair(*pull(f - 1))
                self._cc_frame = frame
            pair = self.fifo.pop(0) if self.fifo else (0, 0)
            data = encode_chars(*pair)
            a = np.frombuffer(bytes(data), np.uint8)
            packed[b, :len(a)] = a
            packed[b, 2] &= 1        # 17 data bits
            active[b] = 1.0
            if claimed is not None:
                claimed[b] = True
        return {"packed": packed, "active": active}

    def apply(self, out, arrays, lut=None):
        wave = vbidata.render(
            vbidata.device_unpack_bits(arrays["packed"], 32), self.d_basis)
        wave = wave + arrays["active"][:, None] * self.d_cri[None, :]
        return out + wave
