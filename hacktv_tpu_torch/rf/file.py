"""File / stdout sink with the reference's output formats.

Port of hacktv_tpu/rf/file.py, numpy only.  The command line writes
through the native runtime's NativeFileSink, which gives the same bytes;
this plain sink is not a fallback for it.  Mirrors src/rf_file.c: data types uint8/int8/uint16/int16/int32/float in
real or complex layout.  Real output takes the I channel only
(src/rf_file.c:97-114).  Input is always int16-scaled IQ.
"""

from __future__ import annotations

import sys
from typing import BinaryIO

import numpy as np

_CONVERTERS = {
    # name: (dtype, convert(iq int16 -> samples))
    "uint8":  (np.uint8,  lambda x: ((x.astype(np.int32) - (-32768)) >> 8).astype(np.uint8)),
    "int8":   (np.int8,   lambda x: (x.astype(np.int32) >> 8).astype(np.int8)),
    "uint16": (np.uint16, lambda x: (x.astype(np.int32) + 32768).astype(np.uint16)),
    "int16":  (np.int16,  lambda x: x),
    "int32":  (np.int32,  lambda x: ((x.astype(np.int64) << 16) + x).astype(np.int32)),
    "float":  (np.float32, lambda x: (x.astype(np.float64)
                                      * (1.0 / 32767.0)).astype(np.float32)),
}


class FileSink:
    def __init__(self, target: str, data_type: str = "int16",
                 complex_out: bool = True):
        if data_type not in _CONVERTERS:
            raise ValueError(f"unknown output data type {data_type!r}")
        self.data_type = data_type
        self.complex_out = complex_out
        self._own = target != "-"
        self.f: BinaryIO = (open(target, "wb") if target != "-"
                            else sys.stdout.buffer)

    def write(self, iq: np.ndarray) -> None:
        """`iq`: int16 [n, 2] interleaved I/Q."""
        _, conv = _CONVERTERS[self.data_type]
        if self.complex_out:
            data = conv(iq.reshape(-1))
        else:
            data = conv(iq[:, 0])
        data.tofile(self.f)

    def close(self) -> None:
        if self._own:
            self.f.close()
