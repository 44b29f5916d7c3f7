"""Host-side audio pipeline: the 32 kHz audio-rate bookkeeping of the FM
carriers (mono and the A2 second carrier), the AM carrier, NICAM-728 and
DANCE (the BS digital sound of `ntsc-bs`), with the Syster audio
inversion (`systeraudio`) of the source's sound.

Port of hacktv_tpu/audio/chain.py.  The reference processes audio one
output sample at a time inside the video loop (src/video.c:3261-3450).
Here the host fetches the volume-scaled PCM window of each block and
computes the per-class window offsets and carrier tables (numpy, exact
integer arithmetic on the absolute output-sample index).  The FM mono carrier's channel mix, limiter
and phase prefix sums, and the NICAM frame encoder, run on the device
(audio/synth.py, audio/nicam_dev.py); the A2 carriers' held values (two
limiters and the 0.95 scale), the AM gain segments and the A2 pilot's
phase bases are computed here, as the JAX package does; so are DANCE's
frames and differential signs (audio/dance.py), which go to the device
as a sign stream for synth.nicam_add.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import telemetry, transfer
from ..config.standards import Modulation, Preemph, VidConfig
from . import dance as dance_mod
from . import nicam as nicam_mod
from .limiter import Limiter
from .preemph import FLAT_TAPS, taps_for

AUDIO_RATE = 32000
INT16_MAX = 32767

_LIM_HIST = 256      # audio samples of history for limiter/J17 recompute
# longest A2 pilot period (output samples) held as an exact prefix-sum
# table (int64, 8 bytes a sample)
_PILOT_TABLE_MAX = 1 << 23


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
    channel: str = "mono"     # audio source: mono | right | a2m (M - R)
    a2_scale: bool = False    # 0.95 post-limiter scale (A2 modes)
    limiter2: Limiter | None = None   # mono-channel limiter (A2 System M)

    @classmethod
    def create(cls, frequency: float, deviation: float, level: float,
               preemph: Preemph, sample_rate: int, channel: str = "mono",
               a2_scale: bool = False) -> "FMCarrier":
        from fractions import Fraction
        lim = None
        if preemph != Preemph.NONE:
            lim = Limiter(INT16_MAX, 21, taps_for(preemph), FLAT_TAPS)
        fr = Fraction(frequency).limit_denominator(1 << 20) / sample_rate
        return cls(frequency=frequency, deviation=deviation,
                   level_int=int(round(INT16_MAX * level)), limiter=lim,
                   num=fr.numerator, den=fr.denominator,
                   kd=2.0 * np.pi * deviation / (sample_rate * INT16_MAX),
                   eps=_phase_bias(frequency, deviation, sample_rate),
                   channel=channel, a2_scale=a2_scale)


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
                 source, systeraudio: bool = False,
                 a2stereo: bool = False):
        self.conf = conf
        self.S = int(sample_rate)
        self.A = AUDIO_RATE
        self.W = width
        self.source = source
        self.volume_int = int(conf.volume * 256 + 0.5)
        # Syster audio spectrum inversion runs on the raw source audio
        # before volume scaling (src/video.c:3280-3295)
        self.inverter = None
        if systeraudio:
            from ..services.syster import SysterAudioInverter
            self.inverter = SysterAudioInverter()

        slevel = 1.0 if conf.modulation == Modulation.FM else conf.level

        self.fm_mono = None
        if conf.fm_mono_level > 0 and conf.fm_mono_carrier != 0:
            self.fm_mono = FMCarrier.create(
                conf.fm_mono_carrier, conf.fm_mono_deviation,
                conf.fm_mono_level * slevel, conf.fm_mono_preemph, self.S,
                a2_scale=a2stereo)

        # Zweikanalton / A2 second carrier + pilot (src/video.c:4375-4401)
        self.fm_right = None
        self.a2_pilot = None
        if a2stereo and self.fm_mono is not None:
            system_m = conf.fm_mono_carrier == 4_500_000
            self.fm_right = FMCarrier.create(
                conf.fm_mono_carrier + (224_213 if system_m else 242_187.5),
                conf.fm_mono_deviation,
                conf.fm_mono_level * 0.446684 * slevel,   # -7 dB
                conf.fm_mono_preemph, self.S,
                channel="a2m" if system_m else "right", a2_scale=True)
            if system_m:
                self.fm_right.limiter2 = Limiter(
                    INT16_MAX, 21, taps_for(conf.fm_mono_preemph),
                    FLAT_TAPS)
            from fractions import Fraction
            f_sig = 149.9 if system_m else 117.5
            f_pil = 55.06993e3 if system_m else 54.6875e3
            r_sig = Fraction(f_sig).limit_denominator(1 << 20) / self.S
            r_pil = Fraction(f_pil).limit_denominator(1 << 20) / self.S
            self.a2_pilot = {
                "num1": r_sig.numerator, "den1": r_sig.denominator,
                "num2": r_pil.numerator, "den2": r_pil.denominator,
                "level2": round(INT16_MAX * 0.05),
            }
            self._pilot_anchor = (0, 0.0)   # (sample index, cum sum)
            # the pilot value is periodic in the output sample with the
            # period T of both tones; where T is short, its running sums
            # come from one exact table instead of every sample's cos
            T = math.lcm(r_sig.denominator, r_pil.denominator)
            self._pilot_prefix = None
            if T <= _PILOT_TABLE_MAX:
                self._pilot_prefix = np.concatenate([[0], np.cumsum(
                    self.pilot_s2(0, T).astype(np.int64))])

        self.am_mono = None
        if conf.am_audio_level > 0 and conf.am_mono_carrier != 0:
            # AM audio carrier (src/video.c:2343-2378, 3426-3429): no
            # limiter/pre-emphasis, half-modulation by (s+32768)/2
            self.am_mono = FMCarrier.create(
                conf.am_mono_carrier, 0.0,
                conf.am_audio_level * slevel, Preemph.NONE, self.S)

        self.nicam = None
        # A2 disables NICAM (src/video.c:4399-4401)
        if conf.nicam_level > 0 and conf.nicam_carrier != 0 \
                and not a2stereo:
            self.nicam = {
                "timing": nicam_mod.SymbolTiming.create(self.S),
                "taps": nicam_mod.mod_taps(self.S, conf.nicam_beta,
                                           conf.nicam_level * slevel),
            }
            fi = int(round(conf.nicam_carrier))
            g = math.gcd(fi, self.S)
            self.nicam["num"], self.nicam["den"] = fi // g, self.S // g

        self.dance = None
        if conf.dance_level > 0 and conf.dance_carrier != 0:
            self.dance = {
                "timing": nicam_mod.SymbolTiming.create(
                    self.S, dance_mod.DANCE_SYMBOL_RATE),
                "taps": nicam_mod.mod_taps(
                    self.S, conf.dance_beta, conf.dance_level * slevel,
                    dance_mod.DANCE_SYMBOL_RATE),
            }
            # dance_mod_init takes the carrier as unsigned int -> the
            # 63e6/11 Hz BS carrier truncates (src/video.c:4538,964)
            fi = int(conf.dance_carrier)
            g = math.gcd(fi, self.S)
            self.dance["num"], self.dance["den"] = fi // g, self.S // g
            # differential-symbol anchor: (frame index, dsym entering it)
            self._dance_dsym_anchor: tuple[int, int] = (0, 0)

        # Max segments a line can span: audio events in W samples + hold
        self.nseg = _ceil_div(width * self.A, self.S) + 2

        # per-carrier: up to two most-recent _held_values windows
        self._held_cache: dict = {}
        # per-carrier deviation-phase anchors of the host-held paths:
        # (audio index, phase mod 2pi) for fm_block, and (audio index,
        # X mod M) for fm_compact_block
        self._dev_anchor: dict = {}
        self._int_anchor: dict = {}

    # -- audio fetch ----------------------------------------------------
    def _pcm(self, start: int, count: int) -> np.ndarray:
        """Volume-scaled int16 stereo pairs [count, 2]; index -1 and below
        are the pre-stream silence."""
        out = np.zeros((count, 2), dtype=np.int64)
        lo = max(start, 0)
        if lo < start + count:
            if self.inverter is not None:
                raw = self._inverted(lo, start + count - lo)
            else:
                raw = self.source.read_audio(lo, start + count - lo)
            if self.volume_int == 256 and raw.dtype == np.int16:
                # (v*256 + 128) >> 8 == v for any int16 v: skip the
                # scale/clip pass at the default volume
                out[lo - start:] = raw
            else:
                v = (raw.astype(np.int64) * self.volume_int + 128) >> 8
                out[lo - start:] = np.clip(v, -32768, 32767)
        return out

    def _inverted(self, lo: int, n: int) -> np.ndarray:
        """Spectrum-inverted pairs [lo, lo+n) through a rolling span
        cache: the FM and NICAM feeds request overlapping ranges each
        block, and the 771-tap inversion is index-pure, so only the
        uncovered head/tail spans are computed."""
        hi = lo + n
        c = getattr(self, "_inv_cache", None)
        if c is None or lo > c[0] + len(c[1]) or hi < c[0]:
            arr = self.inverter.process(self.source.read_audio, lo, n)
            self._inv_cache = [lo, arr]
            return arr
        base, arr = c
        if lo < base:
            head = self.inverter.process(self.source.read_audio, lo,
                                         base - lo)
            arr = np.concatenate([head, arr])
            base = lo
        end = base + len(arr)
        if hi > end:
            tail = self.inverter.process(self.source.read_audio, end,
                                         hi - end)
            arr = np.concatenate([arr, tail])
        drop = lo - base - 8192
        if drop > 0:
            arr = arr[drop:]
            base += drop
        self._inv_cache = [base, arr]
        return arr[lo - base:lo - base + n]

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
            pcm = transfer.upload(self._nicam_pcm_win(fa, dst),
                                  dsym.device)
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

    def nicam_dev_dsym(self, dsym) -> None:
        """Store the differential-state carry (a device scalar) that the
        block's step produced, for the next block's args."""
        fa, _ = self._nicam_dev_anchor
        self._nicam_dev_anchor = (fa, dsym)

    # -- checkpoint/resume ----------------------------------------------
    # The chain's cross-block state is a handful of anchors; the held-value
    # caches are recomputed and dropped.  The NICAM carry leaves the device
    # as numpy, so that a checkpoint resumes on any device.
    _CARRIER_SLOTS = ("fm_mono", "fm_right", "am_mono")

    def state_dict(self) -> dict:
        names = {id(getattr(self, nm)): nm for nm in self._CARRIER_SLOTS
                 if getattr(self, nm, None) is not None}
        remap = lambda d: {names[k]: v for k, v in d.items() if k in names}
        st = {"int_anchor": remap(self._int_anchor),
              "dev_anchor": remap(self._dev_anchor)}
        for a in ("_pilot_anchor", "_dance_dsym_anchor"):
            if hasattr(self, a):
                st[a] = getattr(self, a)
        anc = getattr(self, "_nicam_dev_anchor", None)
        if anc is not None:
            dsym = anc[1]
            st["_nicam_dev_anchor"] = (anc[0], dsym.cpu().numpy()
                                       if isinstance(dsym, torch.Tensor)
                                       else np.asarray(dsym))
        return st

    def load_state(self, st: dict, device) -> None:
        """Restore state_dict() into this (identically configured) chain;
        the NICAM carry goes to `device`."""
        ids = {nm: id(getattr(self, nm)) for nm in self._CARRIER_SLOTS
               if getattr(self, nm, None) is not None}
        self._int_anchor = {ids[nm]: v for nm, v in st["int_anchor"].items()}
        self._dev_anchor = {ids[nm]: v for nm, v in st["dev_anchor"].items()}
        self._held_cache = {}
        for a in ("_pilot_anchor", "_dance_dsym_anchor"):
            if a in st:
                setattr(self, a, st[a])
        if "_nicam_dev_anchor" in st:
            fa, dsym = st["_nicam_dev_anchor"]
            self._nicam_dev_anchor = (fa, torch.as_tensor(dsym,
                                                          device=device))

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

        def channel_vals(ch: str, limiter) -> np.ndarray:
            if ch == "mono":
                v = np.trunc((pcm[:, 0] + pcm[:, 1]) / 2).astype(np.int64)
            else:
                v = pcm[:, 1].copy()
            if limiter is not None:
                v = limiter.process(v)
            if carrier.a2_scale:
                # src/video.c:3328,3350: int16 = sample * 0.95 truncates
                # toward zero
                v = np.trunc(v * 0.95).astype(np.int64)
            return v

        if carrier.channel == "a2m":
            # System M A2 second carrier carries L-R as mono-right
            # (src/video.c:3410-3414)
            vals = (channel_vals("mono", carrier.limiter2)
                    - channel_vals("right", carrier.limiter))
        else:
            vals = channel_vals(carrier.channel, carrier.limiter)
        vals = vals[i_lo - h0: i_hi - h0].copy()
        # indices < 0: initial fm.sample == 0 before the first fetch
        if i_lo < 0:
            vals[: -i_lo] = 0
        self._held_cache[id(carrier)] = ((i_lo, i_hi, vals),) + cached[:1]
        return vals

    # -- host-held FM, AM and the A2 pilot ---------------------------------
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

    @telemetry.spanned("fm.feed")
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

    def _seg_pattern(self, k0: int, nlines: int):
        """Per-(line, seg) hold-value indices and segment start columns
        for lines [k0, k0+nlines), exploiting the line/audio-rate
        periodicity: the event pattern repeats every P_a lines offset by
        a constant pair count, so only [P_a, nseg] is computed exactly
        and the block expands by broadcast adds.

        Returns (vidx [nlines, nseg] int64, seg_col [nlines, nseg] i32).
        Negative stream lines clamp to line 0 like the reference's
        warm-up swallowing."""
        W, S, A = self.W, self.S, self.A
        j = np.arange(self.nseg, dtype=np.int64)
        g = math.gcd(W * A, S)
        q, d = (W * A) // g, S // g
        P_a = d // math.gcd(q % d if q % d else d, d)
        k0c = max(k0, 0)

        if P_a <= max(nlines, 256) and k0 >= 0:
            G_ = -(-nlines // P_a)
            b = np.arange(P_a, dtype=np.int64)
            m0 = (k0c + b) * q // d + 1
            vidx0 = m0[:, None] - 2 + j[None, :]
            ev0 = _ceil_div(S * (m0[:, None] - 1 + j[None, :]), A) - 1
            col0 = ev0 - ((k0c + b) * W)[:, None]
            col0[:, 0] = np.minimum(col0[:, 0], 0)
            m_step = P_a * q // d
            gidx = np.arange(G_, dtype=np.int64)[:, None, None]
            vidx = (vidx0[None, :, :] + gidx * m_step
                    ).reshape(-1, self.nseg)[:nlines]
            seg_col = np.broadcast_to(
                col0[None, :, :].astype(np.int32),
                (G_, P_a, self.nseg)).reshape(-1, self.nseg)[:nlines]
            return vidx, seg_col

        ks = np.maximum(np.arange(k0, k0 + nlines, dtype=np.int64), 0)
        n_line = ks * W
        m_first = n_line * A // S + 1
        vidx = m_first[:, None] - 2 + j[None, :]
        ev = _ceil_div(S * (m_first[:, None] - 1 + j[None, :]), A) - 1
        seg_col = ev - n_line[:, None]
        seg_col[:, 0] = np.minimum(seg_col[:, 0], 0)
        return vidx, seg_col.astype(np.int32)

    def fm_block(self, carrier: FMCarrier, k0: int, nlines: int) -> dict:
        """Host-assembled FM block, for carriers whose phase modulus is
        not exact (fm_win_config gives None): per-line segment values,
        f32 phase bases mod 2pi at each segment start, segment columns
        and the per-line carrier rotation, for lines [k0, k0+nlines)."""
        vidx, seg_col = self._seg_pattern(k0, nlines)
        i_lo = int(vidx.min())
        i_hi = int(vidx.max()) + 1

        held = self._held_values(carrier, i_lo, i_hi)
        idx = np.clip(vidx - i_lo, 0, None)
        seg_val = held.astype(np.float32)[idx]

        # deviation phase base at each segment start:
        # Phi(seg) = kd * sum_{i' < vidx} s_{i'} * len_{i'}
        base = self._dev_phase_bases(carrier, i_lo, i_hi, held)
        seg_base = (base % (2.0 * np.pi)).astype(np.float32)[idx]

        # advance the anchor so that later blocks do not rescan: the next
        # block's i_lo is always >= i_hi - 8 (the halo lines overlap)
        last = max(i_lo, i_hi - 8)
        self._dev_anchor[id(carrier)] = (
            last, float(base[last - i_lo] % (2.0 * np.pi)))

        c0, s0 = self._carrier_rot(carrier.num, carrier.den, k0, nlines)
        return dict(seg_val=seg_val, seg_base=seg_base, seg_col=seg_col,
                    ctab=c0, stab=s0)

    def _dev_phase_bases(self, carrier: FMCarrier, i_lo: int, i_hi: int,
                         held: np.ndarray) -> np.ndarray:
        """Phi at the start of each hold period for indices [i_lo, i_hi):
        cumulative kd * s * len over all earlier hold periods, measured
        from the stream start (mod 2pi, anchored)."""
        ai, aphi = self._dev_anchor.get(id(carrier), (0, 0.0))
        if ai > i_lo:
            # recompute from stream start (seek backwards)
            ai, aphi = -1, 0.0
        if ai < i_lo:
            idx = np.arange(ai, i_lo, dtype=np.int64)
            lens = self.hold_start(idx + 1) - self.hold_start(idx)
            vals = self._held_values(carrier, ai, i_lo)
            aphi = (aphi + carrier.kd * float(np.sum(vals * lens))) \
                % (2.0 * np.pi)
        idx = np.arange(i_lo, i_hi, dtype=np.int64)
        lens = self.hold_start(idx + 1) - self.hold_start(idx)
        csum = np.concatenate([[0], np.cumsum(held * lens)[:-1]])
        return aphi + carrier.kd * csum

    def fm_compact_block(self, carrier: FMCarrier, k0: int, nlines: int,
                         fw) -> dict:
        """Host side of a device-assembled FM block whose held values are
        computed here (the A2 carriers): held values (int16), the exact
        int32 phase anchor, per-class window offsets and per-period
        carrier tables, as synth.fm_prepare takes them."""
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
        held = self._held_values(carrier, i0, i_hi)
        n = i_hi - i0
        assert n <= fw.NH, (n, fw.NH)
        hbuf = np.zeros(fw.NH, dtype=np.int16)
        hbuf[:n] = held

        xa = self._fm_int_anchor(carrier, i0, held, i_hi, fw.M)

        start0 = (vfirst - i0).astype(np.int64)
        c0, s0 = self._carrier_tabs(carrier, k0, nlines)
        return dict(held=hbuf, xa=xa,
                    lens_off=i0 % (A // math.gcd(S, A)),
                    offq=(start0 // m_step).astype(np.int32),
                    offr=(start0 % m_step).astype(np.int32),
                    col0=col0.astype(np.int32), ctab=c0, stab=s0)

    def _fm_int_anchor(self, carrier: FMCarrier, i0: int,
                       held: np.ndarray, i_hi: int, M: int) -> int:
        """Exact integer deviation-phase accumulator X mod M at hold
        index i0, chained block to block (negative indices contribute 0:
        fm.sample is 0 before the first audio fetch)."""
        key = id(carrier)
        ai, xa = self._int_anchor.get(key, (i0 if i0 <= 0 else 0, 0))
        if ai > i_hi - 1:
            ai, xa = (min(i0, 0), 0)
        if ai > i0:
            # subtract the overlap using this block's held values
            w = held[: ai - i0].astype(np.int64)
            xa = (xa - int(np.sum(w * self._lens_for(i0, ai - i0)))) % M
        elif ai < i0:
            w = self._held_values(carrier, ai, i0).astype(np.int64)
            xa = (xa + int(np.sum(w * self._lens_for(ai, i0 - ai)))) % M
        # advance the anchor near the end of this window
        last = max(i0, i_hi - 8)
        w = held[: last - i0].astype(np.int64)
        nxt = (xa + int(np.sum(w * self._lens_for(i0, last - i0)))) % M
        self._int_anchor[key] = (last, nxt)
        return xa

    def am_block(self, carrier: FMCarrier, k0: int, nlines: int) -> dict:
        """Zero-order-hold AM gain segments: value (s+32768)/2 per held
        sample (src/video.c:2359-2366), plus the carrier rotation."""
        vidx, seg_col = self._seg_pattern(k0, nlines)
        i_lo, i_hi = int(vidx.min()), int(vidx.max()) + 1
        pcm = self._pcm(i_lo, i_hi - i_lo)
        mono = np.trunc((pcm[:, 0] + pcm[:, 1]) / 2).astype(np.int64)
        if i_lo < 0:
            mono[: -i_lo] = 0
        s2 = ((mono + 32768) // 2).astype(np.float32)
        seg_val = s2[np.clip(vidx - i_lo, 0, None)]
        c0, s0 = self._carrier_rot(carrier.num, carrier.den, k0, nlines)
        return dict(seg_val=seg_val, seg_col=seg_col, c0=c0, s0=s0)

    def pilot_s2(self, n0: int, count: int) -> np.ndarray:
        """A2 pilot/mode-signal contribution s2 for absolute output
        samples [n0, n0+count): the 117.5/149.9 Hz mode tone AM-modulating
        the ~54.7 kHz pilot, mirroring the reference's integer chain
        (src/video.c:2359-2378, 3404-3421)."""
        ap = self.a2_pilot
        n = np.arange(n0 + 1, n0 + 1 + count, dtype=np.int64)
        th1 = 2 * np.pi * ((n * ap["num1"]) % ap["den1"]) / ap["den1"]
        th2 = 2 * np.pi * ((n * ap["num2"]) % ap["den2"]) / ap["den2"]
        p1 = np.clip(np.floor(np.cos(th1) * 32768.0), -32768, 32767)
        s1 = np.floor(np.floor(p1 / 2) * 32767.0 / 32768.0)
        u = np.floor((s1 + 32768.0) / 2)
        p2 = np.clip(np.floor(np.cos(th2) * 32768.0), -32768, 32767)
        return np.floor(np.floor(p2 * u / 32768.0) * ap["level2"]
                        / 32768.0)

    def pilot_block(self, k0: int, nlines: int) -> dict:
        """Per-line pilot-sum phase bases + pilot carrier rotations for
        lines [k0, k0+nlines)."""
        ap = self.a2_pilot
        W = self.W
        n_start = max(k0, 0) * W
        n_end = (max(k0, 0) + nlines) * W
        line_n = n_start + np.arange(nlines, dtype=np.int64) * W
        tab = self._pilot_prefix
        if tab is not None:
            # the sum over [0, n): whole periods and the table; every
            # value is an integer, so these int64 sums are the f64
            # running sums below exactly
            T = len(tab) - 1
            bases = ((line_n // T) * tab[-1] + tab[line_n % T]).astype(
                np.float64)
        else:
            na, cum = self._pilot_anchor
            if na > n_start:
                na, cum = 0, 0.0
            s2 = self.pilot_s2(na, n_end - na)
            csum = np.concatenate([[0.0], np.cumsum(s2)]) + cum
            bases = csum[line_n - na]
            self._pilot_anchor = (n_end, float(csum[-1]))

        kd = self.fm_right.kd
        out = {"base_phase": ((kd * bases) % (2.0 * np.pi)
                              ).astype(np.float32)}
        for tag, num, den in (("1", ap["num1"], ap["den1"]),
                              ("2", ap["num2"], ap["den2"])):
            rot = (line_n % den) * num % den
            ang = 2.0 * np.pi * rot / den
            out["c" + tag] = np.cos(ang).astype(np.float32)
            out["s" + tag] = np.sin(ang).astype(np.float32)
        return out


    # -- DANCE block ----------------------------------------------------
    def dance_block(self, k0: int, nlines: int, st) -> dict:
        """Per-block arrays of the DANCE subcarrier for lines [k0,
        k0+nlines), in the window scheme of NICAM's synth.nicam_add: the
        differential sign stream from the host coder, zero-prepadded by
        one period so that pre-stream symbols read 0, and the per-class
        window offsets."""
        P, S = st.period, st.nslot
        spp = st.syms_per_period
        G = -(-nlines // P)
        fs_ = dance_mod.DANCE_FRAME_SYMS

        # first line of each block-local class c is stream line k0 + c;
        # class rows advance by exactly spp symbols per period
        ks = np.arange(k0, k0 + P, dtype=np.int64)
        cls = ks % P
        kf0 = st.kf[cls] + (ks - cls) // P * spp   # may be < 0 at start
        sym_lo = max(0, int(kf0.min()))
        sym_hi = int(kf0.max()) + (G - 1) * spp + S
        f0 = sym_lo // fs_
        f1 = (sym_hi - 1) // fs_ + 1
        signs = self._dance_signs(f0, f1)          # [nframes*syms, 2]

        off0 = (kf0 - f0 * fs_ + spp).astype(np.int64)
        L = (G + 4) * spp
        assert off0.min() >= 0 and off0.max() + (G - 1) * spp + S <= L
        buf = np.zeros((2, L), dtype=np.float32)
        m = min(len(signs), L - spp)
        buf[:, spp:spp + m] = signs[:m].T

        n_line = np.arange(k0, k0 + nlines, dtype=np.int64) * self.W
        return dict(signs_i=buf[0], signs_q=buf[1],
                    offq=(off0 // spp).astype(np.int32),
                    offr=(off0 % spp).astype(np.int32),
                    cc_off=(n_line % self.dance["den"]).astype(np.int32))

    def _dance_signs(self, f0: int, f1: int) -> np.ndarray:
        """Differential I/Q signs of the symbols of frames [f0, f1).  The
        differential state chains frame to frame through an anchor
        (frame index, dsym entering it), left a few frames behind f1: the
        next block's first pulse reaches back across the boundary."""
        fa, da = self._dance_dsym_anchor
        if fa > f0:
            fa, da = 0, 0   # seek backwards: recompute from stream start
        frames = self._dance_frames(fa, f1)
        pairs = dance_mod.frame_symbols(frames).reshape(-1)
        signs, _ = nicam_mod.differential_encode(pairs, da)
        last = f1 - 3
        if last > fa:
            nsym = dance_mod.DANCE_FRAME_SYMS
            steps = nicam_mod.STEP[pairs[: (last - fa) * nsym]]
            self._dance_dsym_anchor = (last, int((da + steps.sum()) & 3))
        return signs[(f0 - fa) * dance_mod.DANCE_FRAME_SYMS:]

    def _dance_audio_block(self, f: int) -> int:
        """Audio 32-pair block held in the modulator when frame f is
        encoded: the frame encode fires at output sample
        timing.start(1024 f) inside dance_mod_output for that line,
        AFTER the whole line's audio-rate events ran
        (src/video.c:3261-3443 order); the newest complete block wins.
        Returns the block index (pairs [32j, 32(j+1))), or -1 for the
        initial silence."""
        n_f = int(self.dance["timing"].start(f * dance_mod.DANCE_FRAME_SYMS))
        line_end = (n_f // self.W + 1) * self.W
        pairs_read = int(self.held_index(line_end - 1)) + 1
        return pairs_read // dance_mod.DANCE_A_AUDIO_LEN - 1

    def _dance_frames(self, f0: int, f1: int) -> np.ndarray:
        """DANCE frames [f0, f1).  Frame f's range codes come from the
        audio block visible at its own encode; its sample payload from
        the block of frame f-1's encode (double buffering,
        src/dance.c:229-231,257-261).  The pre-emphasis FIR runs over
        the concatenated per-call input blocks in call order."""
        if f1 <= f0:
            return np.zeros((0, dance_mod.DANCE_FRAME_BYTES), dtype=np.uint8)
        n = dance_mod.DANCE_A_AUDIO_LEN
        # calls needed: [f0-1, f1) for the frames, plus 3 earlier calls
        # (the FIR's 76 samples of history < 3*32) to rebuild its state;
        # block indices are computable for any call, so no rescan from
        # the stream start is ever needed
        c_lo = f0 - 4
        ncalls = f1 - c_lo
        pcm_calls = np.zeros((ncalls * n, 2), dtype=np.int64)
        for ci in range(ncalls):
            c = c_lo + ci
            j = self._dance_audio_block(c) if c >= 0 else -1
            if j >= 0:
                pcm_calls[ci * n: (ci + 1) * n] = self._pcm(j * n, n)
        pre = np.stack([dance_mod.pre_emphasis(pcm_calls[:, 0]),
                        dance_mod.pre_emphasis(pcm_calls[:, 1])],
                       axis=-1)[3 * n:]
        return dance_mod.encode_frames(pre, f0)


def _ceil_div(a, b):
    return -(-a // b)
