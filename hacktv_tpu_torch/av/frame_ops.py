"""Frame orientation ops (src/av.c:242-303): O(1) numpy views.

Port of the orientation part of hacktv_tpu/av/frame_ops.py; the rest of
that module (fit, crop, letterbox) serves the moving-video inputs, which
are not ported yet."""

from __future__ import annotations

import numpy as np


def hflip(rgb: np.ndarray) -> np.ndarray:
    return rgb[:, ::-1]


def vflip(rgb: np.ndarray) -> np.ndarray:
    return rgb[::-1]


def rotate(rgb: np.ndarray, a: int) -> np.ndarray:
    """Rotate by a quarter turns."""
    a %= 4
    if a in (1, 3):
        rgb = np.swapaxes(rgb[::-1], 0, 1)
    if a in (2, 3):
        rgb = rgb[::-1, ::-1]
    return rgb
