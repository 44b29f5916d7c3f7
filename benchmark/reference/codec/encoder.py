"""The plain reference encoder: a frozen copy of the port's block
synthesis for the raster modes the benchmark runs, in plain PyTorch on
any device, with nothing carried from block to block.

    raster (video/raster.py) -> stream FIR (ops/stream_fir.py, an addcmul
    chain) -> FM mono sound (audio/synth.py) or the host-exact FM sound
    carrier of the FM-video modes (fm_exact.py) -> NICAM
    (audio/nicam_dev.py, audio/synth.py) -> int16 wrap -> FM video
    (fm_exact.py, host)

Each block is computed on its own: the FM sound's phase anchor is the
host-exact sum of every held sample before the block, NICAM's
differential state is caught up from the stream start, and the FIR reads
a fresh halo line.  The FM-video modes' two serial recurrences (the
sound carrier and the video modulator, one Python step a sample) start
from states the caller passes, and return their end states.

Supported: PAL and NTSC rasters, from index-addressable sources, without
services, scramblers, the resampler, A2, AM or DANCE sound, offset,
swap-IQ or passthru.  Anything else raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .audio import nicam as nicam_mod
from .audio import nicam_dev
from .audio import synth as audio_synth
from .audio.chain import _LIM_HIST, AudioChain
from .av.testcard import TestCardSource
from .config.standards import ColourMode, Modulation, OutputType, get_mode
from .fm_exact import INITIAL_STATE, FmCarrierExact
from .ops.stream_fir import stream_fir
from .video import raster
from .video.params import VideoParams

_INDEX_KEYS = ("base", "nxt", "prv", "vy", "al", "ar", "lut_row", "fsc",
               "fscf")
_FLOAT_KEYS = ("burst", "vswitch", "cos0", "sin0")


class Encoder:
    def __init__(self, mode: str, sample_rate: int, source=None,
                 frames_per_block: int = 1, vfilter: bool = False,
                 device="cuda", fir_dtype=None):
        """`fir_dtype` computes the stream FIR in a lower precision than
        float32 (the benchmark's control)."""
        conf = get_mode(mode)
        if vfilter:
            conf = replace(conf, vfilter=True)
        if (conf.mac_mode is not None or conf.colour_mode not in (
                ColourMode.PAL, ColourMode.NTSC) or conf.offset
                or conf.swap_iq or conf.s_video or conf.frame_orientation
                or conf.fm_energy_dispersal or conf.dance_level > 0):
            raise NotImplementedError(f"the reference does not run {mode}")
        self.conf = conf
        self.device = torch.device(device)
        self.fir_dtype = fir_dtype
        self.params = p = VideoParams.create(conf, sample_rate, 0)
        self.frames_per_block = frames_per_block
        if source is None:
            source = TestCardSource(p.active_width, conf.active_lines)
        if not getattr(source, "stateless", False):
            raise NotImplementedError("the reference reads index-"
                                      "addressable sources only")
        self.source = source
        self.vframe_x = (p.active_width - source.width) // 2
        self.vframe_y = (conf.active_lines - source.height) // 2
        self.statics = raster.make_statics(p, self.vframe_x, source.width)
        self.dstatics = raster.to_device(self.statics, self.device)
        self._use_prv = bool(np.any(self.statics.sync_head))
        self.vf_taps = None
        if p.vfilter_ctaps is not None:
            self.vf_taps = tuple(
                torch.as_tensor(np.ascontiguousarray(a))
                for a in (p.vfilter_ctaps.real, p.vfilter_ctaps.imag))
        elif p.vfilter_taps is not None:
            self.vf_taps = (torch.as_tensor(p.vfilter_taps), None)
        self.complex_out = conf.output_type == OutputType.COMPLEX
        self._init_audio()
        self.fm_video = None
        if conf.modulation == Modulation.FM:
            self.fm_video = FmCarrierExact(
                0.0, conf.fm_deviation, p.sample_rate,
                int(round(32767 * conf.fm_level * conf.level)))
        # the upstream output ring (src/video.c:3578, 4641-4688): raster,
        # [video filter], audio, [FM video], output
        procs = [(3, False)]
        if self.vf_taps is not None:
            procs.append((2, True))
        procs.append((1, True))
        if self.fm_video is not None:
            procs.append((1, True))
        procs.append((1, False))
        olines, prev_thread = 0, True
        for i, (nl, th) in enumerate(procs):
            olines += nl - (0 if (i == 0 or th or prev_thread) else 1)
            prev_thread = th
        self._spill_warmup = olines - 1

    def _init_audio(self):
        p = self.params
        dev = self.device
        self.audio = AudioChain(self.conf, p.sample_rate, p.width,
                                self.source)
        a = self.audio
        nlines = self.frames_per_block * p.lines
        self.fm_statics = self.fm_win = self.fm_exact = None
        c = a.fm_mono
        if c is not None and self.conf.modulation == Modulation.FM:
            self.fm_exact = FmCarrierExact(c.frequency, c.deviation,
                                           p.sample_rate, c.level_int)
        elif c is not None:
            self.fm_statics = audio_synth.make_fm_statics(
                c.num, c.den, c.level_int, c.kd, p.width, a.nseg, c.eps,
                device=dev)
            self.fm_win = a.fm_win_config(c, nlines, dev)
            if self.fm_win is None:
                raise NotImplementedError("the reference holds the FM "
                                          "sound on the device only")
        self.nicam_statics = None
        if a.nicam is not None:
            nt = a.nicam
            self.nicam_statics = st = audio_synth.make_nicam_statics(
                nt["taps"], nt["num"], nt["den"], p.width, nt["timing"],
                device=dev)
            spp = st.syms_per_period
            G = -(-nlines // st.period)
            L = (G + 4) * spp
            nf_max = (G * spp + st.nslot) // nicam_mod.NICAM_FRAME_SYMS + 12
            self.nicam_dev_statics = nicam_dev.make_dev_statics(
                nf_max, L, spp, device=dev)

    def _block_meta(self, k0: int, nlines: int) -> dict:
        p = self.params
        meta = p.line_meta(k0 - 1, nlines + 2,
                           vframe_interlaced=self.source.interlaced,
                           vframe_x=self.vframe_x, vframe_y=self.vframe_y,
                           vframe_w=self.source.width,
                           vframe_h=self.source.height,
                           spill_warmup=self._spill_warmup)
        out = {k: torch.as_tensor(meta[k].astype(np.int64),
                                  device=self.device) for k in _INDEX_KEYS}
        out.update({k: torch.as_tensor(meta[k].astype(np.float32),
                                       device=self.device)
                    for k in _FLOAT_KEYS})
        return out

    def _fm_mono(self, a_k0: int, nlines: int) -> tuple:
        """fm_add's segment arguments, the phase anchor the host-exact sum
        of every held sample before the block."""
        c, fw, a = self.audio.fm_mono, self.fm_win, self.audio
        i0 = a.fm_dev_i0(a_k0, fw)
        xa = torch.tensor(a.fm_dev_seed_xa(c, i0, fw), dtype=torch.int32,
                          device=self.device)
        d, got_i0, _ = a.fm_compact_block_dev(c, a_k0, nlines, fw, xa)
        assert got_i0 == i0, (got_i0, i0)
        for k in ("pcm", "col0", "ctab", "stab"):
            d[k] = torch.as_tensor(d[k], device=self.device)
        held = audio_synth.held_device(c, d["pcm"], _LIM_HIST)
        args, _ = audio_synth.fm_prepare(
            fw, self.fm_statics, nlines, held, d["xa"], d["lens_off"],
            d["offq"], d["offr"], d["col0"], d["ctab"], d["stab"],
            adv=d["adv"])
        return args

    def _nicam(self, a_k0: int, nlines: int):
        """NICAM's signs and window offsets, the differential state
        caught up from the stream start."""
        self.audio._nicam_dev_anchor = (0, 0)
        fn = lambda *x: nicam_dev.signs_device(self.nicam_dev_statics, *x)
        nc = self.audio.nicam_device_block(
            a_k0, nlines, self.nicam_statics, self.nicam_dev_statics, fn)
        pcm = torch.as_tensor(nc["pcm"], device=self.device)
        si, sq, _ = nicam_dev.signs_device(
            self.nicam_dev_statics, pcm, nc["dsym_in"], nc["famod16"],
            nc["base_off"], nc["nkeep"])
        return si, sq, nc

    def _fm_exact_block(self, a_k0: int, nlines: int, state) -> np.ndarray:
        """The host-exact sound carrier for the block's output samples,
        int16 [nlines, W, 2], from `state` = (carrier state, sample)."""
        W = self.params.width
        n0, n1 = a_k0 * W, (a_k0 + nlines) * W
        fx, c = self.fm_exact, self.audio.fm_mono
        fx.state, fx.n = state
        if fx.n < n0:
            fx.process(self.audio.fm_exact_stream(c, fx.n, n0), fx.n,
                       emit=False)
        out = fx.process(self.audio.fm_exact_stream(c, n0, n1), n0)
        return out.reshape(nlines, W, 2)

    def initial_states(self) -> dict:
        """The serial recurrences' states at the stream start."""
        out = {}
        if self.fm_exact is not None:
            out["fm_sound"] = (INITIAL_STATE, 0)
        if self.fm_video is not None:
            out["fm_video"] = (INITIAL_STATE, 0)
        return out

    @torch.no_grad()
    def encode_block(self, block_no: int, states: dict | None = None):
        """Block `block_no`'s int16 samples, [n, 2] (I, Q) or [n] for
        real output, and the serial recurrences' states after it.
        `states` holds each recurrence's (state, sample) at the block's
        start (`initial_states` at block 0)."""
        p = self.params
        W = p.width
        nlines = self.frames_per_block * p.lines
        n = nlines * W
        k0 = block_no * nlines
        a_k0 = k0 + (1 if self.conf.vfilter else 0)
        states = dict(states or {})

        rgb = self.source.read_video(block_no * self.frames_per_block)
        yuv = tuple(torch.as_tensor(x, device=self.device)
                    for x in raster.rgb_to_yuv_host(p, rgb))
        m = self._block_meta(k0, nlines)
        block = raster.synth_block(
            self.dstatics, yuv, m["base"], m["nxt"], m["burst"],
            m["vswitch"], m["vy"], m["al"], m["ar"], m["cos0"], m["sin0"],
            m["lut_row"], m["prv"] if self._use_prv else None, m["fsc"],
            m["fscf"], split_chroma=False, stacked_h=0)
        if block_no == 0:
            block[0] *= 0.0          # zero filter history at the start
        x = block.reshape(-1)
        yq = None
        if self.vf_taps is not None:
            taps_r, taps_i = self.vf_taps
            half = taps_r.shape[0] // 2
            xs = x[W - half: W - half + n + taps_r.shape[0] - 1]
            y = stream_fir(xs, taps_r, taps_i, n, dtype=self.fir_dtype)
            if taps_i is not None:
                y, yq = y
                yq = yq.view(nlines, W)
            y = y.view(nlines, W)
        else:
            y = x[W: W + n].view(nlines, W)
        out_i = y
        out_q = yq if yq is not None else torch.zeros_like(out_i)
        if self.fm_statics is not None:
            out_i, out_q = audio_synth.fm_add(
                self.fm_statics, out_i, out_q, *self._fm_mono(a_k0, nlines),
                a2=False)
        if self.fm_exact is not None:
            fx = torch.as_tensor(self._fm_exact_block(
                a_k0, nlines, states["fm_sound"]), device=self.device)
            states["fm_sound"] = (self.fm_exact.state, self.fm_exact.n)
            out_i = out_i + fx[..., 0]
            out_q = out_q + fx[..., 1]
        if self.nicam_statics is not None:
            si, sq, nc = self._nicam(a_k0, nlines)
            out_i, out_q = audio_synth.nicam_add(
                self.nicam_statics, out_i, out_q, si, sq, nc["offq"],
                nc["offr"], torch.as_tensor(nc["cc_off"], device=self.device),
                a_k0 % self.nicam_statics.period, line0=0,
                block_lines=nlines)
        # int16 wrap, as every upstream mix into the line buffer
        wrap = lambda v: ((v + 0x8000) & 0xFFFF) - 0x8000
        ii = wrap(torch.round(out_i).to(torch.int32))
        qq = wrap(torch.round(out_q).to(torch.int32))
        out = torch.stack([ii, qq], dim=-1).to(torch.int16).cpu().numpy()
        if self.fm_video is not None:
            fv = self.fm_video
            fv.state, fv.n = states["fm_video"]
            if fv.n != block_no * n:
                raise ValueError("the FM-video state is not at the block")
            out = fv.process(np.ascontiguousarray(out[..., 0]).reshape(-1),
                             fv.n)
            states["fm_video"] = (fv.state, fv.n)
            return out, states
        if not self.complex_out:
            return out[..., 0].reshape(-1), states
        return out.reshape(-1, 2), states
