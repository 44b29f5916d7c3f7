"""Look-ahead soft limiter, vectorised and bit-exact (port of
hacktv_tpu/audio/limiter.py: the host numpy `process` unchanged, and
`device_process` in torch).

Re-derivation of the reference limiter (src/fir.c:748-871) as a batch
algorithm at the 32 kHz audio rate:

  - "variable" path filtered by the pre-emphasis FIR, "fixed" path by the
    flat FIR then hard-limited; var = v - f
  - the circular att/var/fix buffers implement a 20-sample output delay
    with detection at the window centre; in batch form the attack envelope
    is a max-dilation of per-sample attack impulses with the raised-cosine
    shape, centred on the over-level sample
  - all integer roundings ( >>15 arithmetic shifts, C truncating division)
    are reproduced exactly

The cost is O(N * width) numpy work at 32 kHz — negligible next to the
sample-rate synthesis on the device.
"""

from __future__ import annotations

import numpy as np
import torch

INT16_MAX = 32767


def _fir_int32(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Causal int32 FIR with Q15 taps: out[n] = (sum taps[k]*x[n-k]) >> 15
    (src/fir.c:623-694).  x int array, zero history."""
    q = np.round(taps * 32767.0)
    # exact: the true accumulator is an integer with |acc| <=
    # sum|q| * max|x| << 2^53; overlap-add FFT convolution's absolute
    # error (~1e-5) is far below 0.5, so round() recovers it exactly,
    # and acc/2^15 is then an exact f64 (power-of-two divide), so
    # floor() == the >>15 arithmetic shift.  |out| <= sum|q|*32767 >>
    # 15 < 2^22 for the unity-gain J.17/flat tap sets, so the
    # reference's int32 clamp can never engage.
    try:
        from scipy.signal import oaconvolve as _conv
    except Exception:                            # pragma: no cover
        _conv = np.convolve
    acc = np.round(_conv(x.astype(np.float64), q)[:len(x)])
    return np.floor(acc * (1.0 / 32768.0)).astype(np.int64)


class Limiter:
    """Stateless-over-history limiter: call with the full audio history
    window; outputs align 1:1 with inputs (the reference's 20-sample
    internal delay is reproduced)."""

    def __init__(self, level: int = INT16_MAX, width: int = 21,
                 vtaps: np.ndarray | None = None,
                 ftaps: np.ndarray | None = None):
        self.level = level
        self.width = width | 1
        w = self.width
        self.vtaps = vtaps
        self.ftaps = ftaps
        i = np.arange(w)
        self.shape = np.round(
            (1.0 - np.cos(2.0 * np.pi / (w + 1) * (i + 1))) * 0.5 * INT16_MAX
        ).astype(np.int64)

    def _firs(self, x: np.ndarray):
        """Both causal FIRs with ONE forward FFT (the tap spectra are
        cached); same exactness argument as _fir_int32."""
        if self.vtaps is None and self.ftaps is None:
            return x.copy(), x.copy()
        try:
            from scipy.fft import irfft, next_fast_len, rfft
        except Exception:                        # pragma: no cover
            v = (_fir_int32(x, self.vtaps) if self.vtaps is not None
                 else x.copy())
            f = (_fir_int32(x, self.ftaps) if self.ftaps is not None
                 else x.copy())
            return v, f
        n = len(x)
        nt = max(len(t) for t in (self.vtaps, self.ftaps)
                 if t is not None)
        L = next_fast_len(n + nt - 1)
        spec = getattr(self, "_tap_spec", None)
        if spec is None or spec[0] != L:
            mk = lambda t: (None if t is None else
                            rfft(np.round(t * 32767.0), L))
            spec = (L, mk(self.vtaps), mk(self.ftaps))
            self._tap_spec = spec
        X = rfft(x.astype(np.float64), L)
        out = []
        for tf, taps in ((spec[1], self.vtaps), (spec[2], self.ftaps)):
            if tf is None:
                out.append(x.copy())
                continue
            acc = np.round(irfft(X * tf, L)[:n])
            out.append(np.floor(acc * (1.0 / 32768.0)).astype(np.int64))
        return out

    def device_process(self, x: torch.Tensor) -> torch.Tensor:
        """Torch mirror of process() for the device audio path, in pure
        int32 (integer-identical to process()).  The FIR accumulates in
        int32 like the reference (src/fir.c int32 FIR); the two wide
        products are decomposed into exact int32 pieces:

          - t*32767 // d  with 0 <= t <= d < 2^23 splits via the
            identity t*32767 = t*2^15 - t and three chained divmods
            (every partial quotient fits because t <= d)
          - (var * k) >> 15 with |var| < 2^23, 0 <= k <= 2^16 uses
            (var*kh + ((var*kl) >> 8)) >> 7 for k = kh*2^8 + kl, which
            equals the 64-bit floor shift exactly.

        torch's integer `//` and `%` round towards -inf, as numpy's do."""
        i32 = torch.int32
        n = x.shape[0]
        w = self.width
        half = w // 2
        lvl = int(self.level)
        x = x.to(i32)

        def fir(taps):
            if taps is None:
                return x
            q = np.round(taps * 32767.0).astype(np.int32)
            nt = len(q)
            xp = torch.cat([x.new_zeros(nt - 1), x])
            # sum|q|*32767 can reach ~4x int32 for the pre-emphasis tap
            # sets on full-scale input, so accumulate the exact value as
            # hi/lo int32 pieces of x = xh*2^8 + xl:
            #   acc>>15 == (accH + (accL >> 8)) >> 7   (exact floor)
            xh = xp >> 8
            xl = xp & 0xFF
            accH = x.new_zeros(n)
            accL = x.new_zeros(n)
            for k in range(nt):
                c = int(q[k])
                s = slice(nt - 1 - k, nt - 1 - k + n)
                accH += c * xh[s]
                accL += c * xl[s]
            return (accH + (accL >> 8)) >> 7

        def mul_shift15(var, k):
            kh = k >> 8
            kl = k & 0xFF
            return (var * kh + ((var * kl) >> 8)) >> 7

        v = fir(self.vtaps)
        f = torch.clamp(fir(self.ftaps), -lvl, lvl)
        var = v - f
        a = torch.abs(v)
        over = a > lvl
        absvar = torch.abs(var)
        d = torch.where(absvar == 0, 1, absvar)
        # t*32767 // d, exact: t = q0*d + r0 (q0 in {0,1} since t<=d),
        # r0*2^8 = q1*d + r1, r1*2^7 = q2*d + r2, tail (r2 - t)//d
        t = lvl + absvar - a
        q0, r0 = t // d, t % d
        q1, r1 = (r0 << 8) // d, (r0 << 8) % d
        q2, r2 = (r1 << 7) // d, (r1 << 7) % d
        quot = (q0 << 15) + (q1 << 7) + q2 + (r2 - t) // d
        att_imp = torch.where(over, INT16_MAX - quot, 0)
        att = x.new_zeros(n + w)
        for j in range(w):
            contrib = (att_imp * int(self.shape[j])) >> 15
            att[j:j + n] = torch.maximum(att[j:j + n], contrib)
        att = att[half:half + n]
        out = f + mul_shift15(var, INT16_MAX - att)
        out = torch.clamp(out, -lvl, lvl)
        dd = w - 1
        return torch.cat([x.new_zeros(dd), out[:n - dd]])

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: int16-valued array (the limiter is fed vin == fin by the
        reference, src/video.c:3320-3322).  Returns int16-valued int64."""
        x = np.asarray(x, dtype=np.int64)
        n = len(x)
        w = self.width
        half = w // 2
        lvl = self.level

        v, f = self._firs(x)
        f = np.clip(f, -lvl, lvl)
        var = v - f

        # Attack impulse per over-level sample (detection at window centre)
        a = np.abs(v)
        over = a > lvl

        # Envelope: att[t] = max_d att_imp[d] * shape[t - d + half] >> 15,
        # a max-dilation — w shifted whole-array maxima (np.maximum.at
        # over the per-impulse index lists is quadratic when a loud
        # source keeps every sample over level).  Skipped entirely when
        # nothing is over level (the common case for in-range sources):
        # att == 0 everywhere and the dilation is w wasted passes.
        if not over.any():
            out = f + ((var * np.int64(INT16_MAX)) >> 15)
        else:
            absvar = np.abs(var)
            # guarded: where over, |var| > 0 (v > lvl while f clipped
            # to lvl)
            denom = np.where(absvar == 0, 1, absvar)
            att_imp = np.where(
                over,
                INT16_MAX - (lvl + absvar - a) * INT16_MAX // denom,
                0,
            )
            att2 = np.zeros(n + w, dtype=np.int64)
            for j in range(w):
                contrib = (att_imp * self.shape[j]) >> 15
                np.maximum(att2[j:j + n], contrib, out=att2[j:j + n])
            att = att2[half:half + n]
            out = f + ((var * (INT16_MAX - att)) >> 15)
        out = np.clip(out, -lvl, lvl)

        # 20-sample (width-1) output delay with zero fill, matching the
        # reference's circular-buffer latency
        d = w - 1
        return np.concatenate([np.zeros(d, dtype=np.int64), out[:n - d]])
