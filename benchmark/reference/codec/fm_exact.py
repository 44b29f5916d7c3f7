"""The upstream exact FM carrier generator (src/video.c:2218-2276) in
plain Python: the int32 phase (I, Q) times a quantised per-sample-value
LUT phasor, truncating >>31 multiplies, an atan2 renormalisation every
32767 samples.  Strictly serial, one Python step a sample."""

from __future__ import annotations

import math

import numpy as np

_M = 2147483647.0
INITIAL_STATE = (2147483647, 0, 32767)     # phase I, phase Q, counter


def _llround(x: float) -> int:
    """C's llround: half away from zero."""
    return int(math.copysign(math.floor(abs(x) + 0.5), x))


class FmCarrierExact:
    """One carrier; `state` is (phase I, phase Q, counter) and `n` the
    absolute output-sample index it has reached."""

    def __init__(self, frequency: float, deviation: float,
                 sample_rate: int, level_int: int):
        r = np.arange(-32768, 32768, dtype=np.float64)
        d = 2.0 * np.pi / sample_rate * (frequency + r / 32767.0
                                         * deviation)

        def lround(x):
            return np.where(x >= 0, np.floor(x + 0.5), -np.floor(-x + 0.5))
        self._cos = lround(np.cos(d) * _M).astype(np.int64).tolist()
        self._sin = lround(np.sin(d) * _M).astype(np.int64).tolist()
        self.level = int(level_int)
        self.state = INITIAL_STATE
        self.n = 0

    def process(self, samples: np.ndarray, n0: int,
                emit: bool = True) -> np.ndarray | None:
        """int16 [len, 2] (I, Q) carrier for output samples [n0, n0 +
        len); n0 must continue the stream."""
        if n0 != self.n:
            raise ValueError(f"carrier stream discontinuity: {n0} != "
                             f"{self.n}")
        idx = (np.asarray(samples, np.int64) + 32768).tolist()
        lc, ls = self._cos, self._sin
        pi, pq, counter = self.state
        keep_i = [0] * len(idx) if emit else None
        keep_q = [0] * len(idx) if emit else None
        atan2, cos, sin = math.atan2, math.cos, math.sin
        for t, k in enumerate(idx):
            c = lc[k]
            s = ls[k]
            pi, pq = (pi * c - pq * s) >> 31, (pi * s + pq * c) >> 31
            if emit:
                keep_i[t] = pi
                keep_q[t] = pq
            counter -= 1
            if not counter:
                ra = atan2(pq, pi)
                pi = _llround(cos(ra) * _M)
                pq = _llround(sin(ra) * _M)
                counter = 32767
        self.state = (pi, pq, counter)
        self.n += len(idx)
        if not emit:
            return None
        out = np.empty((len(idx), 2), np.int16)
        for j, keep in enumerate((keep_i, keep_q)):
            v = np.array(keep, np.int64)
            out[:, j] = (((v >> 16) * self.level) >> 15).astype(np.int16)
        return out
