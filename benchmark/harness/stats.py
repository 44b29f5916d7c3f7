"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def window_rate(samples: int, t0: float, t_end: float) -> float:
    """All samples handed to the sink in the window over the window's
    seconds (t0: its start, t_end: the return of its last write)."""
    return samples / (t_end - t0)


def gaps(t0: float, returns: list) -> list:
    """The time between one sink write returning and the next, for every
    write of the window; the first from the window's start (the return
    of the last write before it)."""
    marks = [t0] + list(returns)
    return [b - a for a, b in zip(marks, marks[1:])]


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100), linear between closest ranks (numpy's
    default), over all the values."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

