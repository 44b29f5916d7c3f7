"""The plain reference encoder of SECAM-L: hacktv's `-m l` (SECAM colour,
625 lines, VSB with positive video levels, AM mono sound at 6.5 MHz and
NICAM-728 at 5.85 MHz), written in plain PyTorch on any device.

    raster (reference/codec/video/raster.py) -> SECAM chroma and luma
    band-reject (secam.py) -> stream FIR (reference/codec/ops/
    stream_fir.py) -> AM sound (this file) -> NICAM (reference/codec/
    audio) -> int16 wrap

Each block is computed on its own.  The one serial carry across blocks,
the chroma IIR's state, starts from the end of the last active line
before the block (secam.py's docstring says why that line alone sets
it); a caller may hand the state in (`states["secam_iir"]`) to stream
the blocks instead, and gets the next block's back.  The AM carrier's
phase and its held sound sample follow from the output sample's index.
"""

from __future__ import annotations

import math
from dataclasses import replace
from fractions import Fraction

import numpy as np
import torch

from reference.codec.audio import nicam as nicam_mod
from reference.codec.audio import nicam_dev
from reference.codec.audio import synth as audio_synth
from reference.codec.audio.chain import AUDIO_RATE, AudioChain, _phase_bias
from reference.codec.config.standards import (ColourMode, Modulation,
                                              OutputType, get_mode)
from reference.codec.ops.stream_fir import stream_fir
from reference.codec.video import raster
from reference.codec.video.params import VideoParams

from .secam import INT32_MAX, SecamLine

_INDEX_KEYS = ("base", "nxt", "prv", "vy", "al", "ar", "lut_row", "fsc",
               "fscf")
_FLOAT_KEYS = ("burst", "vswitch", "cos0", "sin0")


class Encoder:
    def __init__(self, mode: str, sample_rate: int, source,
                 frames_per_block: int = 1, vfilter: bool = True,
                 device="cuda", fir_dtype=None):
        """`fir_dtype` computes the stream FIR in a lower precision than
        float32 (the benchmark's control)."""
        conf = get_mode(mode)
        if vfilter:
            conf = replace(conf, vfilter=True)
        if (conf.colour_mode != ColourMode.SECAM
                or conf.modulation != Modulation.VSB
                or conf.output_type != OutputType.COMPLEX
                or not (conf.am_audio_level > 0 and conf.am_mono_carrier)
                or conf.fm_mono_level > 0 or conf.secam_field_id
                or conf.offset or conf.swap_iq or conf.s_video):
            raise NotImplementedError(f"the SECAM-L reference does not run "
                                      f"{mode}")
        if not getattr(source, "stateless", False):
            raise NotImplementedError("the reference reads index-"
                                      "addressable sources only")
        self.conf, self.source = conf, source
        self.device = dev = torch.device(device)
        self.fir_dtype = fir_dtype
        self.params = p = VideoParams.create(conf, sample_rate, 0)
        self.frames_per_block = frames_per_block
        self.vframe_x = (p.active_width - source.width) // 2
        self.vframe_y = (conf.active_lines - source.height) // 2
        self.statics = raster.make_statics(p, self.vframe_x, source.width)
        self.dstatics = raster.to_device(self.statics, dev)
        self._use_prv = bool(np.any(self.statics.sync_head))
        self.secam = SecamLine(p, self.vframe_x, source.width, self.vframe_y,
                               source.height, dev)
        self.vf_taps = None
        if p.vfilter_ctaps is not None:
            self.vf_taps = tuple(
                torch.as_tensor(np.ascontiguousarray(a))
                for a in (p.vfilter_ctaps.real, p.vfilter_ctaps.imag))
        # the upstream output ring (src/video.c:3578, 4641-4688): raster,
        # SECAM, [video filter], audio, output
        procs = [(3, False), (1, True)]
        if self.vf_taps is not None:
            procs.append((2, True))
        procs += [(1, True), (1, False)]
        olines, prev_thread = 0, True
        for i, (nl, th) in enumerate(procs):
            olines += nl - (0 if (i == 0 or th or prev_thread) else 1)
            prev_thread = th
        self._spill_warmup = olines - 1
        self._init_audio()

    def _init_audio(self):
        p, conf, dev = self.params, self.conf, self.device
        # AM mono (src/video.c:2343-2378, 3426-3429): level and carrier
        slevel = conf.level
        self.am_level = int(round(32767 * conf.am_audio_level * slevel))
        r = Fraction(int(round(conf.am_mono_carrier)), p.sample_rate)
        self.am_num, self.am_den = r.numerator, r.denominator
        self.am_eps = _phase_bias(conf.am_mono_carrier, 0.0, p.sample_rate)
        # NICAM through the codec reference's audio chain, without the AM
        # carrier that it does not run
        self.audio = AudioChain(replace(conf, am_audio_level=0.0),
                                p.sample_rate, p.width, self.source)
        nt = self.audio.nicam
        self.nicam_statics = None
        if nt is not None:
            nlines = self.frames_per_block * p.lines
            self.nicam_statics = st = audio_synth.make_nicam_statics(
                nt["taps"], nt["num"], nt["den"], p.width, nt["timing"],
                device=dev)
            spp = st.syms_per_period
            G = -(-nlines // st.period)
            nf_max = (G * spp + st.nslot) // nicam_mod.NICAM_FRAME_SYMS + 12
            self.nicam_dev_statics = nicam_dev.make_dev_statics(
                nf_max, (G + 4) * spp, spp, device=dev)

    def initial_states(self) -> dict:
        """The recurrences the check follows from the program: none."""
        return {}

    # ------------------------------------------------------------------
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

    def _secam(self, block, k_first: int, u, v, iir0, k_snap: int):
        """The SECAM line process over the block's rows (stream lines
        k_first, k_first + 1, ...; `block` f32 [R, W] the raster's): the
        luma band-reject and the chroma carrier on the active lines.
        The IIR starts from `iir0` (float64 [2]) or, where None, from
        the end of the last active line before k_first.  Returns the
        rows and the IIR's state at the end of the last active line
        before k_snap."""
        sc = self.secam
        R, W = block.shape
        infos = [sc.line(k_first + j) for j in range(R)]
        act = [j for j in range(R)
               if infos[j]["active"] and k_first + j >= 0]
        # the last active line before the block, for a cold start
        prev = None
        if iir0 is None:
            k = k_first - 1
            while k >= 0 and not sc.line(k)["active"]:
                k -= 1
            prev = sc.line(k) if k >= 0 else None
        rows = [infos[j] for j in act]
        x = sc.chroma_fir(([prev] if prev else []) + rows, u, v)
        _, ends = sc.iir(x, None)
        if prev is not None:
            x, ends, iir0 = x[1:], ends[1:], ends[0]
        if iir0 is None:
            iir0 = torch.zeros(2, dtype=torch.float64, device=block.device)
        start = torch.cat([torch.as_tensor(iir0, dtype=torch.float64,
                                           device=block.device)[None],
                           ends[:-1]])
        y, ends = sc.iir(x, start)
        dr = torch.tensor([i["dr"] for i in rows], device=block.device)
        c = sc.clamp(y, dr)
        add = torch.zeros((R, W), dtype=torch.int64, device=block.device)
        add[act] = sc.carrier(c, rows)
        # the luma band-reject over the active segment of active lines
        line_act = [j for j in range(R) if infos[j]["active"]]
        out = block.clone()
        a0, a1 = sc.active_left, sc.active_left + sc.active_width
        out[line_act, a0:a1] = sc.luma(block[line_act])[:, a0:a1].to(
            out.dtype)
        out = out + add.to(out.dtype)
        before = [i for i, j in enumerate(act) if k_first + j < k_snap]
        snap = ends[before[-1]] if before else start[0]
        return out, snap

    def _am(self, a_k0: int, nlines: int):
        """The AM sound carrier's I and Q, int64 [nlines, W], for audio
        lines a_k0, a_k0 + 1, ...: the 6.5 MHz phase at output sample n
        is 2 pi num (n + 1) / den (upstream's int32 phasor, whose drift
        decides its ties: _phase_bias), times (s + 32768) / 2 of the mono
        sample held at n, times the level."""
        p, dev = self.params, self.device
        W, S = p.width, p.sample_rate
        n = (a_k0 * W + torch.arange(nlines * W, dtype=torch.int64,
                                     device=dev)).view(nlines, W)
        held = (n + 1) * AUDIO_RATE // S - 1
        lo, hi = int(held.min()), int(held.max()) + 1
        pcm = np.zeros((hi - lo, 2), np.int64)
        first = max(lo, 0)
        if first < hi:
            pcm[first - lo:] = self.source.read_audio(first, hi - first)
        mono = np.trunc((pcm[:, 0] + pcm[:, 1]) / 2).astype(np.int64)
        s = torch.as_tensor((mono + 32768) >> 1, device=dev)[held - lo]
        rot = (((n + 1) * self.am_num) % self.am_den).to(torch.float64)
        theta = 2.0 * math.pi * rot / self.am_den + self.am_eps
        mix = lambda t: (((torch.floor(t * INT32_MAX).to(torch.int64) >> 16)
                          * s >> 15) * self.am_level) >> 15
        return mix(torch.cos(theta)), mix(torch.sin(theta))

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

    @torch.no_grad()
    def encode_block(self, block_no: int, states: dict | None = None):
        """Block `block_no`'s int16 samples [n, 2] (I, Q), and the states
        after it: "secam_iir", the chroma IIR's (last input, last output)
        at the next block's first row.  `states["secam_iir"]`, where
        given, is this block's (streaming); else it is computed."""
        p = self.params
        W = p.width
        nlines = self.frames_per_block * p.lines
        n = nlines * W
        k0 = block_no * nlines
        a_k0 = k0 + (1 if self.conf.vfilter else 0)
        states = dict(states or {})

        rgb = self.source.read_video(block_no * self.frames_per_block)
        yuv = tuple(torch.as_tensor(x, device=self.device)
                    for x in raster.rgb_to_yuv_host(p, rgb, True))
        m = self._block_meta(k0, nlines)
        block = raster.synth_block(
            self.dstatics, yuv, m["base"], m["nxt"], m["burst"],
            m["vswitch"], m["vy"], m["al"], m["ar"], m["cos0"], m["sin0"],
            m["lut_row"], m["prv"] if self._use_prv else None, m["fsc"],
            m["fscf"], split_chroma=False, stacked_h=0)
        block, states["secam_iir"] = self._secam(
            block, k0 - 1, yuv[1], yuv[2], states.get("secam_iir"),
            k0 + nlines - 1)
        if block_no == 0:
            block[0] *= 0.0          # zero filter history at the start
        x = block.reshape(-1)
        yq = None
        if self.vf_taps is not None:
            taps_r, taps_i = self.vf_taps
            half = taps_r.shape[0] // 2
            xs = x[W - half: W - half + n + taps_r.shape[0] - 1]
            y, yq = stream_fir(xs, taps_r, taps_i, n, dtype=self.fir_dtype)
            y, yq = y.view(nlines, W), yq.view(nlines, W)
        else:
            y = x[W: W + n].view(nlines, W)
        out_i = y
        out_q = yq if yq is not None else torch.zeros_like(out_i)
        am_i, am_q = self._am(a_k0, nlines)
        out_i = out_i + am_i.to(torch.float32)
        out_q = out_q + am_q.to(torch.float32)
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
        return out.reshape(-1, 2), states
