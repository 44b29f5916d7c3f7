"""Batched VBI symbol rendering (port of hacktv_tpu/services/vbidata.py).

The reference pre-computes per-symbol pulse-shaped sample runs and adds
them per set bit (src/vbidata.c).  Here each service's symbol set becomes
a dense basis matrix [n_symbols, width] and rendering a block of lines is
one matmul: waveform = bits @ basis.

Basis values are integer-rounded exactly like the reference LUTs, so the
waveforms match bit for bit.  `render` sums in f64 and rounds once to
f32: every partial sum is an integer of magnitude at most the largest
column sum of |basis| (`sum_bound`), below 2^24 for every service, so the
f32 result is exact whatever the order of the sums, equal to the JAX
package's f32 HIGHEST-precision matmul, and does not depend on torch's
TF32 switch (TF32 keeps 11 bits of mantissa; teletext's pulses reach
about 15,000 and WSS's more).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.shapes import raised_cosine, rc_window

#: every partial sum of `render` stays below this magnitude, where f32
#: holds every integer exactly
EXACT_BOUND = 1 << 24


def basis_rc(nsymbols: int, width: int, level: int, bwidth: float,
             beta: float, offset: float, margin: int = 0) -> np.ndarray:
    """Raised-cosine symbol basis (src/vbidata.c:83-121 `_vbidata_init`).

    Row b covers samples [-margin, width): symbol b's pulse is the
    raised-cosine centred at `offset + bwidth*b`, sampled at integers and
    rounded.  `margin` extends rows to the left for pulses that spill into
    the previous line.
    """
    rows = np.zeros((nsymbols, margin + width), dtype=np.float32)
    x = np.arange(-margin, width, dtype=np.float64)
    for b in range(nsymbols):
        t = -bwidth * b - offset
        rows[b] = np.round(raised_cosine((t + x) / bwidth, beta, 1.0) * level)
    return rows


def basis_step(nsymbols: int, width: int, level: int, swidth: float,
               rise: float, offset: float, margin: int = 0) -> np.ndarray:
    """Flat-top symbol basis with integrated-raised-cosine edges
    (src/vbidata.c:143-165 `_vbidata_init_step`)."""
    rows = np.zeros((nsymbols, margin + width), dtype=np.float32)
    x = np.arange(-margin, width, dtype=np.float64)
    for b in range(nsymbols):
        rows[b] = np.round(
            rc_window(x, offset + swidth * b, swidth, rise) * level)
    return rows


def bytes_to_bits(data: bytes | np.ndarray, nbits: int,
                  lsb_first: bool = True) -> np.ndarray:
    """Unpack bytes into a float32 bit vector of length nbits."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) \
        if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    bits = np.unpackbits(arr, bitorder="little" if lsb_first else "big")
    return bits[:nbits].astype(np.float32)


def sum_bound(basis: np.ndarray) -> float:
    """The largest magnitude any partial sum of bits @ basis can take:
    the largest column sum of |basis|."""
    return float(np.abs(np.asarray(basis, np.float64)).sum(axis=0).max())


def render(bits: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """bits [B, n] (0/1) @ basis [n, W] -> f32 [B, W], exact: the sums
    run in f64 and round once to f32 (see the module docstring)."""
    return torch.matmul(bits.to(torch.float64),
                        basis.to(torch.float64)).to(torch.float32)


def device_unpack_bits(packed: torch.Tensor, nbits: int,
                       dtype=torch.float32) -> torch.Tensor:
    """uint8 [B, nbytes] (LSB-first) -> `dtype` [B, nbits] on the device.
    Bit rows travel host -> device packed (a [B, 360] f32 teletext block
    is 8 times the bytes)."""
    sh = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> sh) & 1
    return bits.reshape(packed.shape[0], -1)[:, :nbits].to(dtype)
