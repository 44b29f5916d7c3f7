"""Host-side audio pipeline: the 32 kHz audio-rate bookkeeping of the FM
mono carrier and NICAM-728 (the A2 and AM carriers are left out).

Port of hacktv_tpu/audio/chain.py.  The reference processes audio one
output sample at a time inside the video loop (src/video.c:3261-3450).
Here the host fetches the volume-scaled PCM window of each block and
computes the per-class window offsets and carrier tables (numpy, exact
integer arithmetic on the absolute output-sample index).  The FM mono
carrier's channel mix, limiter and phase prefix sums, and the NICAM frame encoder, run on the device
(audio/synth.py, audio/nicam_dev.py); the host-exact FM carrier's held
values are computed here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..config.standards import Modulation, Preemph, VidConfig
from . import nicam as nicam_mod
from .limiter import Limiter
from .preemph import FLAT_TAPS, taps_for

AUDIO_RATE = 32000
INT16_MAX = 32767

_LIM_HIST = 256      # audio samples of history for limiter/J17 recompute


@dataclass
class FMCarrier:
    frequency: float
    deviation: float
    level_int: int            # round(32767 * level * slevel)
    limiter: Limiter | None
    # exact carrier ratio frequency/fs as reduced integers
    num: int = 0
    den: int = 0
    kd: float = 0.0           # rad per (sample * unit)
    eps: float = 0.0          # deterministic phase lag (see below)

    @classmethod
    def create(cls, frequency: float, deviation: float, level: float,
               preemph: Preemph, sample_rate: int) -> "FMCarrier":
        from fractions import Fraction
        lim = None
        if preemph != Preemph.NONE:
            lim = Limiter(INT16_MAX, 21, taps_for(preemph), FLAT_TAPS)
        fr = Fraction(frequency).limit_denominator(1 << 20) / sample_rate
        return cls(frequency=frequency, deviation=deviation,
                   level_int=int(round(INT16_MAX * level)), limiter=lim,
                   num=fr.numerator, den=fr.denominator,
                   kd=2.0 * np.pi * deviation / (sample_rate * INT16_MAX),
                   eps=_phase_bias(frequency, deviation, sample_rate))


def _phase_bias(frequency: float, deviation: float,
                sample_rate: int) -> float:
    """The reference's int32 complex phase iteration (src/video.c:2259)
    accumulates a tiny deterministic phase error whose SIGN decides the
    floor() outcome at the exact zeros of the carrier — which recur every
    few samples for rational carriers and integrate into visible FM phase
    drift.  Simulate the iteration briefly to find the lag direction and
    return a +-1e-6 rad offset that reproduces those tie-breaks."""
    d = 2.0 * np.pi / sample_rate * frequency
    li = round(math.cos(d) * (2**31 - 1))
    lq = round(math.sin(d) * (2**31 - 1))
    pi_, pq = 2**31 - 1, 0
    n = 20000
    for _ in range(n):
        pi_, pq = ((pi_ * li - pq * lq) >> 31,
                   (pi_ * lq + pq * li) >> 31)
    err = (math.atan2(pq, pi_) - n * d) % (2.0 * np.pi)
    if err > np.pi:
        err -= 2.0 * np.pi
    return 1e-6 if err >= 0 else -1e-6


class AudioChain:
    """Per-block audio computation for one video mode."""

    def __init__(self, conf: VidConfig, sample_rate: int, width: int,
                 source):
        self.conf = conf
        self.S = int(sample_rate)
        self.A = AUDIO_RATE
        self.W = width
        self.source = source
        self.volume_int = int(conf.volume * 256 + 0.5)
        # Syster audio spectrum inversion runs on the raw source audio
        # before volume scaling (src/video.c:3280-3295)

        slevel = 1.0 if conf.modulation == Modulation.FM else conf.level

        self.fm_mono = None
        if conf.fm_mono_level > 0 and conf.fm_mono_carrier != 0:
            self.fm_mono = FMCarrier.create(
                conf.fm_mono_carrier, conf.fm_mono_deviation,
                conf.fm_mono_level * slevel, conf.fm_mono_preemph, self.S)

        if conf.am_audio_level > 0 and conf.am_mono_carrier != 0:
            raise NotImplementedError("the reference has no AM sound")

        self.nicam = None
        if conf.nicam_level > 0 and conf.nicam_carrier != 0:
            self.nicam = {
                "timing": nicam_mod.SymbolTiming.create(self.S),
                "taps": nicam_mod.mod_taps(self.S, conf.nicam_beta,
                                           conf.nicam_level * slevel),
            }
            fi = int(round(conf.nicam_carrier))
            g = math.gcd(fi, self.S)
            self.nicam["num"], self.nicam["den"] = fi // g, self.S // g

        # Max segments a line can span: audio events in W samples + hold
        self.nseg = _ceil_div(width * self.A, self.S) + 2

        # per-carrier: up to two most-recent _held_values windows
        self._held_cache: dict = {}

    # -- audio fetch ----------------------------------------------------
    def _pcm(self, start: int, count: int) -> np.ndarray:
        """Volume-scaled int16 stereo pairs [count, 2]; index -1 and below
        are the pre-stream silence."""
        out = np.zeros((count, 2), dtype=np.int64)
        lo = max(start, 0)
        if lo < start + count:
            raw = self.source.read_audio(lo, start + count - lo)
            if self.volume_int == 256 and raw.dtype == np.int16:
                # (v*256 + 128) >> 8 == v for any int16 v: skip the
                # scale/clip pass at the default volume
                out[lo - start:] = raw
            else:
                v = (raw.astype(np.int64) * self.volume_int + 128) >> 8
                out[lo - start:] = np.clip(v, -32768, 32767)
        return out

    # -- compact FM block (device-side segment assembly) -----------------
    def fm_win_config(self, carrier: FMCarrier, nlines: int, device="cuda"):
        """Build the synth.FMWin config for this carrier, or None when
        the exact modular-phase preconditions don't hold."""
        from . import synth as audio_synth
        W, S, A = self.W, self.S, self.A
        g = math.gcd(W * A, S)
        q, d = (W * A) // g, S // g
        P_a = d // math.gcd(q % d if q % d else d, d)
        if P_a > 4096:
            return None
        m_step = P_a * q // d
        dev = carrier.deviation
        if dev <= 0 or dev != int(dev):
            return None
        FS32 = self.S * INT16_MAX
        if FS32 % int(dev):
            return None
        M = FS32 // int(dev)
        if M >= (1 << 26):
            # f32(X) is exact below 2^24; up to 2^26 the conversion can
            # slip by <= 3 units = a phase error <= 6*pi/M < 1.5e-6 rad,
            # far below f32 trig precision (NTSC-M's M is 2^24.08)
            return None
        # hold lengths pattern: len[i] = start(i+1) - start(i), period
        # A / gcd(S, A) in the audio index
        P_len = A // math.gcd(S, A)
        i = np.arange(P_len + 1, dtype=np.int64)
        starts = _ceil_div(S * (i + 1), A) - 1
        lens = (starts[1:] - starts[:-1]).astype(np.int32)
        len_max = int(lens.max())
        prod_bound = INT16_MAX * len_max + 1
        G = -(-nlines // P_a)
        NH = (G + 3) * m_step
        tiled = np.tile(lens, -(-(NH + P_len) // P_len))[:NH + P_len]
        return audio_synth.FMWin(
            P_a=P_a, m_step=m_step, nseg=self.nseg, NH=NH, M=M,
            prod_bound=prod_bound,
            lens_tiled=torch.as_tensor(tiled, device=device))

    def fm_compact_block_dev(self, carrier: FMCarrier, k0: int,
                             nlines: int, fw, xa):
        """Host side of a device FM block: the raw volume-scaled PCM
        window (channel mix, limiter, held values and phase prefix sums
        run on the device), per-class window offsets and per-period
        carrier tables; the int32 phase anchor `xa` is a device scalar
        chained block to block.  Returns (args dict, i0, i0_next)."""
        W, S, A = self.W, self.S, self.A
        g = math.gcd(W * A, S)
        q, d = (W * A) // g, S // g
        P_a, m_step, nseg = fw.P_a, fw.m_step, self.nseg
        G = -(-nlines // P_a)
        j = np.arange(nseg, dtype=np.int64)

        b = np.arange(P_a, dtype=np.int64)
        m0 = (k0 + b) * q // d + 1
        vfirst = m0 - 2
        ev0 = _ceil_div(S * (m0[:, None] - 1 + j[None, :]), A) - 1
        col0 = (ev0 - ((k0 + b) * W)[:, None])
        col0[:, 0] = np.minimum(col0[:, 0], 0)

        i0 = int(vfirst.min())
        i_hi = int(vfirst.max()) + (G - 1) * m_step + nseg
        assert i_hi - i0 <= fw.NH, (i_hi - i0, fw.NH)
        h0 = i0 - _LIM_HIST
        pcmbuf = np.zeros((fw.NH + _LIM_HIST, 2), dtype=np.int32)
        pcmbuf[: i_hi - h0] = self._pcm(h0, i_hi - h0)

        m0n = (k0 + nlines + b) * q // d + 1
        i0n = int((m0n - 2).min())

        start0 = (vfirst - i0).astype(np.int64)
        c0, s0 = self._carrier_tabs(carrier, k0, nlines)
        return dict(
            pcm=pcmbuf,
            xa=xa,
            adv=i0n - i0,
            lens_off=i0 % (A // math.gcd(S, A)),
            offq=(start0 // m_step).astype(np.int32),
            offr=(start0 % m_step).astype(np.int32),
            col0=col0.astype(np.int32),
            ctab=c0, stab=s0,
        ), i0, i0n

    def fm_dev_i0(self, k0: int, fw) -> int:
        """First held-audio index of the block starting at stream line
        k0 (closed form, same expression as fm_compact_block_dev)."""
        W, S, A = self.W, self.S, self.A
        g = math.gcd(W * A, S)
        q, d = (W * A) // g, S // g
        b = np.arange(fw.P_a, dtype=np.int64)
        return int(((k0 + b) * q // d - 1).min())

    def fm_dev_seed_xa(self, carrier: FMCarrier, i0: int, fw) -> int:
        """Host-exact phase accumulator X mod M at i0 for a stream that
        starts mid-sequence (the device anchor chain normally begins at
        block 0 where the pre-span contribution is zero)."""
        start = min(i0, 0)
        if start == i0:
            return 0
        held = self._held_values(carrier, start, i0).astype(np.int64)
        lens = self._lens_for(start, i0 - start)
        return int(np.sum(held * lens) % fw.M)

    def _lens_for(self, i_lo: int, count: int) -> np.ndarray:
        """Hold lengths for audio indices [i_lo, i_lo+count)."""
        i = np.arange(i_lo, i_lo + count + 1, dtype=np.int64)
        starts = _ceil_div(self.S * (i + 1), self.A) - 1
        return starts[1:] - starts[:-1]

    def _carrier_rot(self, num: int, den: int, k0: int, nlines: int):
        """(cos, sin) f32 [nlines] of the exact per-line carrier angle
        2*pi*num*(k*W)/den, via the line-period structure when small."""
        W = self.W
        step = (W % den) * (num % den) % den
        P_r = den // math.gcd(step if step else den, den)
        if P_r <= max(nlines, 256) and k0 >= 0:
            b = np.arange(P_r, dtype=np.int64)
            rot = ((k0 + b) % den) * W % den * num % den
            ang = 2.0 * np.pi * rot / den
            reps = -(-nlines // P_r)
            c = np.tile(np.cos(ang).astype(np.float32), reps)[:nlines]
            s = np.tile(np.sin(ang).astype(np.float32), reps)[:nlines]
            return c, s
        ks = np.maximum(np.arange(k0, k0 + nlines, dtype=np.int64), 0)
        n_line = ks * W
        rot = (n_line % den) * num % den
        ang = 2.0 * np.pi * rot / den
        return (np.cos(ang).astype(np.float32),
                np.sin(ang).astype(np.float32))

    def _carrier_tabs(self, carrier: FMCarrier, k0: int, nlines: int):
        """Per-period carrier rotation tables (cos, sin) rotated for k0;
        full-length fallback when the period is large."""
        num, den, W = carrier.num, carrier.den, self.W
        step = (W % den) * (num % den) % den
        P_r = den // math.gcd(step if step else den, den)
        if P_r <= 4096 and k0 >= 0:
            b = np.arange(P_r, dtype=np.int64)
            rot = ((k0 + b) % den) * W % den * num % den
            ang = 2.0 * np.pi * rot / den
            return (np.cos(ang).astype(np.float32),
                    np.sin(ang).astype(np.float32))
        return self._carrier_rot(num, den, k0, nlines)

    # -- device-encoded NICAM --------------------------------------------
    def nicam_device_block(self, k0: int, nlines: int, st, dst,
                           dev_fn) -> dict:
        """Host side of a NICAM block whose frame encoding and
        differential stream run on the device (nicam_dev.signs_device):
        the PCM window, placement host ints and the per-class window
        offsets.  The differential-state carry stays on the device;
        `dev_fn` (signs_device bound to its statics) runs only to catch
        up after a seek."""
        P, S = st.period, st.nslot
        spp = st.syms_per_period
        G = -(-nlines // P)
        fs_ = nicam_mod.NICAM_FRAME_SYMS

        ks = np.arange(k0, k0 + P, dtype=np.int64)
        cls = ks % P
        kf0 = st.kf[cls] + (ks - cls) // P * spp
        sym_lo = max(0, int(kf0.min()))
        sym_hi = int(kf0.max()) + (G - 1) * spp + S
        f0 = sym_lo // fs_
        f1 = (sym_hi - 1) // fs_ + 1

        fa, dsym = getattr(self, "_nicam_dev_anchor", (0, 0))
        if fa > f0:
            fa, dsym = 0, 0                # backward seek: restart
        if dsym is None:
            raise RuntimeError("NICAM blocks must be encoded sequentially "
                               "(the last block's step gave no carry)")
        if isinstance(dsym, int):          # the stream start
            dsym = torch.zeros((), dtype=torch.int32, device=st.pulse.device)
        # catch up in full windows if the anchor is far behind (seek),
        # never advancing past f0 (the final call must cover [f0, f1))
        while f1 - fa > dst.nf_max:
            nc = min(dst.nf_max - 4, f0 - fa)
            pcm = torch.as_tensor(self._nicam_pcm_win(fa, dst),
                                  device=dsym.device)
            _, _, dsym = dev_fn(pcm, dsym, fa % 16, spp, nc * fs_)
            fa += nc
        base_off = spp - (f0 - fa) * fs_
        assert 0 <= base_off <= spp, (base_off, f0, fa)
        nkeep = max(f1 - 3 - fa, 0) * fs_
        self._nicam_dev_anchor = (max(f1 - 3, fa), None)   # dsym via step

        off0 = (kf0 - f0 * fs_ + spp).astype(np.int64)
        assert off0.min() >= 0 and off0.max() + (G - 1) * spp + S <= dst.L

        n_line = np.arange(k0, k0 + nlines, dtype=np.int64) * self.W
        return dict(pcm=self._nicam_pcm_win(fa, dst),
                    dsym_in=dsym,
                    famod16=fa % 16, base_off=base_off, nkeep=nkeep,
                    offq=(off0 // spp).astype(np.int32),
                    offr=(off0 % spp).astype(np.int32),
                    cc_off=(n_line % self.nicam["den"]).astype(np.int32))

    def _nicam_pcm_win(self, fa: int, dst) -> np.ndarray:
        """PCM window (history first) for frames [fa, fa+nf_max).  Frame
        f carries audio pairs [32(f-1), 32f); frame 0 is the modulator's
        initial silence."""
        hist = nicam_mod.J17_NTAPS - 1
        start = 32 * (fa - 1) - hist
        pcm = self._pcm(start, dst.nf_max * 32 + hist)
        return np.ascontiguousarray(pcm.astype(np.int16))

    def _held_values(self, carrier: FMCarrier, i_lo: int, i_hi: int
                     ) -> np.ndarray:
        """Post-limiter held FM sample for audio indices [i_lo, i_hi)
        (index -1 and below = 0), on the host."""
        cached = self._held_cache.get(id(carrier), ())
        for lo, hi, vals in cached:
            if lo <= i_lo and i_hi <= hi:
                return vals[i_lo - lo: i_hi - lo]
        h0 = i_lo - _LIM_HIST
        pcm = self._pcm(h0, i_hi - h0)

        vals = np.trunc((pcm[:, 0] + pcm[:, 1]) / 2).astype(np.int64)
        if carrier.limiter is not None:
            vals = carrier.limiter.process(vals)
        vals = vals[i_lo - h0: i_hi - h0].copy()
        # indices < 0: initial fm.sample == 0 before the first fetch
        if i_lo < 0:
            vals[: -i_lo] = 0
        self._held_cache[id(carrier)] = ((i_lo, i_hi, vals),) + cached[:1]
        return vals

    # -- the host-exact FM carrier's feed ------------------------------------
    def held_index(self, n) -> np.ndarray:
        """Audio pair index held at output sample n (-1 = initial
        silence): floor((n+1)*A/S) - 1 (src/video.c:3273-3277)."""
        n = np.asarray(n, dtype=np.int64)
        return (n + 1) * self.A // self.S - 1

    def hold_start(self, i) -> np.ndarray:
        """First output sample at which audio pair i is held:
        ceil(S*(i+1)/A) - 1."""
        i = np.asarray(i, dtype=np.int64)
        return _ceil_div(self.S * (i + 1), self.A) - 1

    def fm_exact_stream(self, carrier: FMCarrier, n0: int, n1: int
                        ) -> np.ndarray:
        """Per-output-sample held int16 feed for output samples [n0, n1):
        the value the reference's audio process holds while calling
        _fm_modulator_add (src/video.c:3273-3424).  The held index is
        non-decreasing in n, so each held value repeats over its hold
        period (hold_start(i) to hold_start(i+1), clipped to the range):
        the same values as held_values[held_index(n)] at every n."""
        i_lo = int(self.held_index(n0))
        i_hi = int(self.held_index(n1 - 1)) + 1
        starts = np.clip(self.hold_start(np.arange(i_lo, i_hi + 1)), n0, n1)
        vals = self._held_values(carrier, i_lo, i_hi)
        return np.repeat(np.clip(vals, -32768, 32767).astype(np.int16),
                         np.diff(starts))


def _ceil_div(a, b):
    return -(-a // b)
