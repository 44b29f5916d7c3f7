"""NICAM-728's constants and tables (J.17 taps, PRN, interleave), the
exact rational 364 kbaud symbol timing (src/nicam728.c:301-307, 399-407)
and the pulse-shaping taps, numpy only (from hacktv_tpu/audio/nicam.py).
The frame coder runs on the device (nicam_dev.py), the waveform in
synth.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


NICAM_BIT_RATE = 728000
NICAM_SYMBOL_RATE = NICAM_BIT_RATE // 2
NICAM_AUDIO_RATE = 32000
NICAM_FRAME_BITS = 728
NICAM_FRAME_BYTES = NICAM_FRAME_BITS // 8
NICAM_FRAME_SYMS = NICAM_FRAME_BITS // 2
NICAM_AUDIO_LEN = NICAM_AUDIO_RATE // 1000   # stereo pairs per frame
NICAM_FAW = 0x4E

MODE_STEREO = 0x00

# J.17 pre-emphasis taps, 32 kHz (src/nicam728.c:37-44)
J17_TAPS = np.array([
    -1, 0, -1, -1, -1, -1, -1, -1, -1, -1, -2, -2, -3, -3, -3, -3, -5, -5,
    -6, -7, -9, -10, -13, -14, -18, -21, -27, -32, -42, -51, -69, -86, -120,
    -159, -233, -332, -524, -814, -1402, -2372, -4502, 25590, -4502, -2372,
    -1402, -814, -524, -332, -233, -159, -120, -86, -69, -51, -42, -32, -27,
    -21, -18, -14, -13, -10, -9, -7, -6, -5, -5, -3, -3, -3, -3, -2, -2, -1,
    -1, -1, -1, -1, -1, -1, -1, 0, -1], dtype=np.int64)
J17_NTAPS = len(J17_TAPS)



def prn_sequence() -> np.ndarray:
    """9-bit LFSR whitening bytes for positions 1..90 of the frame
    (src/nicam728.c:96-125)."""
    poly = 0x1FF
    out = np.zeros(NICAM_FRAME_BYTES - 1, dtype=np.uint8)
    for x in range(NICAM_FRAME_BYTES - 1):
        v = 0
        for _ in range(8):
            b = (poly & 1) ^ ((poly >> 4) & 1)
            poly = (poly >> 1) | (b << 8)
            v = ((v << 1) | b) & 0xFF
        out[x] = v
    return out


_PRN = prn_sequence()

# interleave table: bit b of the 704 payload bits maps to position xi
# (src/nicam728.c:220-239): starting xi=0, stepping 16 mod 703.
def _interleave_positions() -> np.ndarray:
    pos = np.zeros(704, dtype=np.int64)
    xi = 0
    for b in range(704):
        pos[b] = xi
        xi += 16
        if xi >= NICAM_FRAME_BITS - 24:
            xi -= NICAM_FRAME_BITS - 24 - 1
    return pos


_ILEAVE = _interleave_positions()


@dataclass
class SymbolTiming:
    """Exact symbol timing at `sample_rate` (src/nicam728.c:301-307):
    symbol k (0-based) starts at output sample S(k) = sps*k - floor(dsl*k
    / decimation)."""
    sps: int
    dsl: int
    decimation: int

    @classmethod
    def create(cls, sample_rate: int,
               symbol_rate: int = NICAM_SYMBOL_RATE) -> "SymbolTiming":
        n = math.gcd(sample_rate, symbol_rate)
        decimation = symbol_rate // n
        sps = (sample_rate + symbol_rate - 1) // symbol_rate
        dsl = (sps * decimation) % (sample_rate // n)
        return cls(sps=sps, dsl=dsl, decimation=decimation)

    def start(self, k):
        k = np.asarray(k, dtype=np.int64)
        return self.sps * k - (self.dsl * k) // self.decimation

    def sym_range(self, n0: int, n1: int, ntaps: int) -> tuple[int, int]:
        """Symbols whose pulse [S(k), S(k)+ntaps) intersects [n0, n1)."""
        # S(k) ~ k * rate; invert conservatively
        avg = self.sps - self.dsl / self.decimation
        k0 = max(0, int((n0 - ntaps) / avg) - 2)
        while self.start(k0 + 1) + ntaps <= n0:
            k0 += 1
        k1 = max(k0, int(n1 / avg) + 2)
        while self.start(k1 - 1) >= n1 and k1 > k0:
            k1 -= 1
        return k0, k1


def mod_taps(sample_rate: int, beta: float, level: float,
             symbol_rate: int = NICAM_SYMBOL_RATE) -> np.ndarray:
    """RRC x Hamming pulse-shaping taps, int16-quantised
    (src/nicam728.c:257-288; identical construction for DANCE,
    src/dance.c:359-390)."""
    from ..ops.shapes import rrc
    sps = sample_rate / float(symbol_rate)
    ntaps = (int(sps * 5) + 1) | 1
    n = ntaps // 2
    x = np.arange(-n, n + 1, dtype=np.float64)
    t = x / sps
    hamming = np.where(np.abs(x / n) <= 1,
                       0.54 - 0.46 * np.cos(np.pi * (1.0 + x / n)), 0.0)
    r = rrc(t, beta, 1.0) * hamming
    r = r * (np.sqrt(0.5) * 32767 * level)
    return np.round(r).astype(np.int64)
