"""VITC timecode (src/vitc.c; port of hacktv_tpu/services/vitc.py): SMPTE
timecode on two lines per field with drop-frame compensation, CRC,
~115xfH flat-top symbols."""

from __future__ import annotations

import numpy as np
import torch

from . import vbidata


def _bits(data: bytearray, offset: int, bits: int, nbits: int) -> int:
    for _ in range(nbits):
        b = 1 << (offset & 7)
        if bits & 1:
            data[offset >> 3] |= b
        else:
            data[offset >> 3] &= ~b
        bits >>= 1
        offset += 1
    return offset


def vitc_payload(frame: int, fps: int, frame_drop: bool, second_field: bool,
                 lines_625: bool) -> bytes:
    """90-bit VITC packet for a frame/field (src/vitc.c:116-198)."""
    fn = frame
    if frame_drop:
        fn += (fn // 17982) * 18
        # C division truncates toward zero: for the first two frames of
        # each 10-minute block the numerator is negative and must give 0,
        # not floor's -1 (src/vitc.c:135-140)
        q = fn % 18000 - 2
        fn += (q // 1798 if q >= 0 else -((-q) // 1798)) * 2
    tc = (fn % fps % 10) | ((fn % fps // 10) << 4)
    tc |= (1 << 6) if frame_drop else 0
    tc |= 1 << 7
    fn //= fps
    tc |= (fn % 10) << 8 | (fn // 10 % 6) << 12
    if not lines_625:
        tc |= (1 if second_field else 0) << 15
    fn //= 60
    tc |= (fn % 10) << 16 | (fn // 10 % 6) << 20
    fn //= 60
    tc |= (fn % 24 % 10) << 24 | (fn % 24 // 10) << 28
    if lines_625:
        tc |= (1 if second_field else 0) << 31

    data = bytearray(12)
    x = 0
    for i in range(8):
        x = _bits(data, x, 0x01, 2)
        x = _bits(data, x, (tc >> (i * 4)) & 0xF, 4)
        x = _bits(data, x, 0x0, 4)          # user bits
    x = _bits(data, x, 0x01, 2)
    _bits(data, x, 0, 8)
    crc = 0
    for i in range(11):
        crc ^= data[i]
    crc = ((crc << 6) | (crc >> 2)) & 0xFF
    x = _bits(data, x, crc, 8)
    return bytes(data), x


class VITC:
    STATICS = ("basis",)

    def __init__(self, params, device="cuda"):
        p = params
        conf = p.conf
        from ..config.standards import RasterType
        if conf.type == RasterType.RASTER_625:
            self.lines = (19, 332)
            hr = 116
            self.is625 = True
        elif conf.type == RasterType.RASTER_525:
            self.lines = (14, 277)
            hr = 115
            self.is625 = False
        else:
            raise ValueError("vitc: unsupported video mode")
        fr = conf.frame_rate
        if fr.num <= 30 and fr.den == 1:
            self.fps, self.frame_drop = fr.num, False
        elif fr.num == 30000 and fr.den == 1001:
            self.fps, self.frame_drop = 30, True
        else:
            raise ValueError("vitc: unsupported frame rate")
        level = round((p.white_level - p.black_level) * 0.785)
        self.basis = vbidata.basis_step(
            hr, p.width, level, p.width / hr,
            p.pixel_rate * 200e-9, 0.0)
        # the packet renders with a 21-symbol offset (src/vitc.c:190)
        self.offset_sym = 21
        self.nbits_total = hr
        self.lines_total = conf.lines
        self.device = torch.device(device)
        self.upload()

    def upload(self):
        """The basis on the device."""
        self.d_basis = torch.as_tensor(self.basis, device=self.device)

    def block_arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        ks = k0 + np.arange(nlines, dtype=np.int64)
        line = np.where(ks >= 0, ks % self.lines_total + 1, 0)
        targets = (self.lines[0], self.lines[0] + 2,
                   self.lines[1], self.lines[1] + 2)
        rows = np.nonzero(np.isin(line, targets))[0]
        nbytes = (self.nbits_total + 7) // 8
        packed = np.zeros((nlines, nbytes), dtype=np.uint8)
        buf = np.zeros(self.nbits_total, dtype=np.uint8)
        pcache = {}     # the 2 lines of a field share one payload
        for b in rows:
            b = int(b)
            k = int(ks[b])
            key = (1 + k // self.lines_total,
                   int(line[b]) >= self.lines[1])
            payload, nbits = pcache.get(key) or pcache.setdefault(
                key, vitc_payload(key[0], self.fps, self.frame_drop,
                                  key[1], self.is625))
            row = vbidata.bytes_to_bits(payload, nbits, lsb_first=True)
            n = min(len(row), self.nbits_total - self.offset_sym)
            buf[:] = 0
            buf[self.offset_sym:self.offset_sym + n] = row[:n]
            packed[b] = np.packbits(buf, bitorder="little")
            if claimed is not None:
                claimed[b] = True
        return {"packed": packed}

    def apply(self, out, arrays, lut=None):
        bits = vbidata.device_unpack_bits(arrays["packed"],
                                          self.nbits_total)
        return out + vbidata.render(bits, self.d_basis)
