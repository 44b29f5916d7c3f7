"""Pulse / window shape primitives (vectorised, float64 host math).

These reproduce the analytic shapes the reference uses to pre-render sync
pulses, burst envelopes and data symbols (src/common.c:231-283 `rc_window`,
`rrc`; src/vbidata.c:25-34 raised cosine).  Everything here runs at init
time on the host in numpy; the device only sees the resulting templates.
"""

from __future__ import annotations

import numpy as np

#: 10-90% rise time to 0-100% conversion for the integrated raised-cosine
#: edge (src/common.h:29).
IRT1090 = 2.0738786


def rc_window(t, left, width, rise):
    """Flat-topped window with integrated-raised-cosine edges.

    `t` may be an array.  Matches src/common.c:231-257: the window is 1.0
    over `[left, left+width]` (minus half the rise each side), falls to 0
    over `rise`, with an integrated raised-cosine profile.
    """
    t = np.asarray(t, dtype=np.float64)
    t = t - (left + width / 2.0)
    t = np.abs(t) - (width - rise) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        u = 1.0 - t / rise * 2.0 if rise != 0 else np.full_like(t, -1.0)
        edge = 0.5 * (1.0 + u + np.sin(np.pi * u) / np.pi)
    r = np.where(t <= 0, 1.0, np.where(t < rise, edge, 0.0))
    return r


def sinc(x):
    x = np.asarray(x, dtype=np.float64)
    out = np.ones_like(x)
    nz = x != 0
    out[nz] = np.sin(np.pi * x[nz]) / (np.pi * x[nz])
    return out


def raised_cosine(x, beta, t):
    """Raised-cosine pulse (src/vbidata.c:30-34), safe at the singular
    points x = 0 and |x| = t/(2*beta)."""
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        den = 1.0 - (4.0 * beta * beta * x * x / (t * t))
        r = sinc(x / t) * np.cos(np.pi * beta * x / t) / den
    # Singularities: x == 0 -> 1; |x| == t/(2 beta) -> limit value
    r = np.where(x == 0, 1.0, r)
    if beta > 0:
        xs = t / (2.0 * beta)
        lim = (np.pi / 4.0) * sinc(1.0 / (2.0 * beta))
        r = np.where(np.isclose(np.abs(x), xs), lim, r)
    return r


def rrc(x, beta, t):
    """Root-raised-cosine pulse, vectorised (src/common.c:259-283)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)

    x0 = x == 0
    out[x0] = (1.0 / t) * (1.0 + beta * (4.0 / np.pi - 1.0))

    xs = np.isclose(np.abs(x), t / (4.0 * beta)) if beta > 0 else np.zeros_like(x0)
    if beta > 0:
        out[xs] = beta / (t * np.sqrt(2.0)) * (
            (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
            + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta)))

    rest = ~(x0 | xs)
    xr = x[rest] / t
    t1 = 4.0 * beta * xr
    num = np.sin(np.pi * xr * (1.0 - beta)) + 4.0 * beta * xr * np.cos(np.pi * xr * (1.0 + beta))
    den = np.pi * xr * (1.0 - t1 * t1)
    out[rest] = (1.0 / t) * num / den
    return out
