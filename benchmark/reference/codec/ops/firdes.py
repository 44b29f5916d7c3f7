"""FIR filter design (host-side, float64 numpy).

Reproduces the designers the reference builds its filters with
(src/fir.c:32-255): Kaiser-windowed low-pass, gaussian chroma low-pass,
band-reject and complex band-pass (for VSB).  Tap values must match the
reference's to reproduce its spectra, so the formulas follow the same
derivations (themselves derived from gnuradio's firdes).

The int16 quantisation helper mirrors how the reference rounds taps to Q15
(src/fir.c:283), so that a float32 convolution using `quantise_taps()`
output is numerically equivalent to the reference integer filter to within
accumulator truncation.
"""

from __future__ import annotations

import numpy as np


def _i0(x: float) -> float:
    """Zeroth-order modified Bessel function (series, src/fir.c:32-51)."""
    total = u = 1.0
    halfx = x / 2.0
    n = 1
    while True:
        t = halfx / n
        n += 1
        u *= t * t
        total += u
        if u < 1e-21 * total:
            return total


def kaiser_window(ntaps: int, beta: float) -> np.ndarray:
    i_beta = 1.0 / _i0(beta)
    w = np.empty(ntaps, dtype=np.float64)
    w[0] = w[-1] = i_beta
    for i in range(1, ntaps - 1):
        t = 2.0 * i / (ntaps - 1) - 1.0
        w[i] = _i0(beta * np.sqrt(1.0 - t * t)) * i_beta
    return w


def low_pass(ntaps: int, sample_rate: float, cutoff: float,
             width: float, gain: float = 1.0) -> np.ndarray:
    """Kaiser (beta=7) windowed-sinc low-pass, DC gain normalised
    (src/fir.c:89-137).  Forces an odd tap count like the reference (an
    even request yields ntaps-1 real taps followed by a zero)."""
    out = np.zeros(ntaps, dtype=np.float64)
    if ntaps % 2 == 0:
        n = ntaps - 1
    else:
        n = ntaps
    taps = kaiser_window(n, 7.0)
    m = (n - 1) // 2
    fw = 2.0 * np.pi * cutoff / sample_rate
    k = np.arange(-m, m + 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        sinc = np.where(k == 0, fw / np.pi, np.sin(k * fw) / (k * np.pi))
    taps = taps * sinc
    fmax = taps[m] + 2.0 * np.sum(taps[m + 1:])
    taps *= gain / fmax
    out[:n] = taps
    return out


def gaussian_low_pass_ntaps(sample_rate: float, cutoff: float) -> int:
    """src/fir.c:139-143."""
    ntaps = int(np.ceil(sample_rate / 1.35e6 / (cutoff / 1.4e6)))
    return ntaps | 1


def gaussian_low_pass(ntaps: int, sample_rate: float, cutoff: float,
                      gain: float = 1.0) -> np.ndarray:
    """Gaussian low-pass used for the chroma filter (src/fir.c:145-177)."""
    out = np.zeros(ntaps, dtype=np.float64)
    n = ntaps - 1 if ntaps % 2 == 0 else ntaps
    f = 13.5e6 / sample_rate
    s = 354372.0 / cutoff
    h = n // 2
    x = np.arange(0, h + 1, dtype=np.float64)
    t = x / 5.0 * f
    r = (1.0 / s) * np.power(2.0 * np.pi, 0.5) * np.exp(-(t ** 2) / (2.0 * s * s))
    total = r[0] + 2.0 * np.sum(r[1:])
    taps = np.empty(n, dtype=np.float64)
    taps[h:] = r
    taps[:h] = r[1:][::-1]
    taps *= gain / total
    out[:n] = taps
    return out


def band_reject(ntaps: int, sample_rate: float, low_cutoff: float,
                high_cutoff: float, width: float, gain: float = 1.0) -> np.ndarray:
    """Kaiser windowed band-reject (src/fir.c:179-228)."""
    out = np.zeros(ntaps, dtype=np.float64)
    n = ntaps - 1 if ntaps % 2 == 0 else ntaps
    taps = kaiser_window(n, 7.0)
    m = (n - 1) // 2
    fw0 = 2.0 * np.pi * low_cutoff / sample_rate
    fw1 = 2.0 * np.pi * high_cutoff / sample_rate
    k = np.arange(-m, m + 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        core = np.where(
            k == 0,
            1.0 + (fw0 - fw1) / np.pi,
            (np.sin(k * fw0) - np.sin(k * fw1)) / (k * np.pi),
        )
    taps = taps * core
    fmax = taps[m] + 2.0 * np.sum(taps[m + 1:])
    taps *= gain / fmax
    out[:n] = taps
    return out


def complex_band_pass(ntaps: int, sample_rate: float, low_cutoff: float,
                      high_cutoff: float, width: float,
                      gain: float = 1.0) -> np.ndarray:
    """Complex band-pass derived by rotating a low-pass (src/fir.c:230-255).

    Returns complex128 taps of length `ntaps`.  Used for the VSB video
    filter with (-vsb_lower_bw, +vsb_upper_bw).
    """
    freq = np.pi * (high_cutoff + low_cutoff) / sample_rate
    lp = low_pass(ntaps, sample_rate, (high_cutoff - low_cutoff) / 2.0, width, gain)
    if ntaps % 2:
        phase0 = -freq * (ntaps >> 1)
    else:
        phase0 = -freq / 2.0 * ((1 + 2 * ntaps) >> 1)
    phase = phase0 + freq * np.arange(ntaps)
    return lp * (np.cos(phase) + 1j * np.sin(phase))


def quantise_taps(taps: np.ndarray, scale: int = 32767) -> np.ndarray:
    """Round taps to Q15 exactly as the reference's int16 filters do
    (src/fir.c:283 `lround(taps[i] * 32767.0)`), then rescale so a float
    convolution matches `(int32 accum) >> 15` up to truncation: the
    effective divisor of the reference's shift is 32768.
    """
    q = np.round(np.asarray(taps, dtype=np.float64) * scale)
    return q / 32768.0
