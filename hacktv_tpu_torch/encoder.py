"""Top-level encoder: source frames -> block synthesis on the device ->
int16 samples.

Port of hacktv_tpu/encoder.py for the raster modes (PAL, NTSC, SECAM and
monochrome) with the video filter, FM mono and A2 stereo sound, AM sound
and NICAM-728 (PAL-I, the flagship chain, PAL-B/G, SECAM-L, D/K, NTSC-M +
VSB `--filter`, the 405-line modes, composite with the low-pass
`--filter`).  A block of `frames_per_block` whole frames, plus one halo
line each side for filter continuity, is synthesised as a sequence of
tensor ops on one device:

    raster (video/raster.py) -> SECAM chroma and render (video/secam.py)
    -> stream FIR (ops/stream_fir.py, the CUDA kernel on a card) -> FM
    and A2 sound carriers, AM sound (audio/synth.py) -> NICAM
    (audio/nicam_dev.py, audio/synth.py) -> int16

The stream-line counter `k` is the only state: k=0 is the first rendered
line, (frame 1, line 1), with zero filter history at the stream start.
The FM phase anchor, the NICAM differential state and the SECAM IIR
state are device scalars chained block to block, so blocks must be
encoded in order.

Metadata, line tables, taps and the audio window bookkeeping stay host
numpy.  Options that are not ported yet raise NotImplementedError.
"""

from __future__ import annotations

import math
import sys
from collections import OrderedDict
from dataclasses import replace

import numpy as np
import torch

from .audio import nicam as nicam_mod
from .audio import nicam_dev
from .audio import synth as audio_synth
from .audio.chain import _LIM_HIST, AudioChain
from .av.testcard import TestCardSource
from .config.standards import (ColourMode, Modulation, OutputType, VidConfig,
                               get_mode)
from .ops.stream_fir import stream_fir
from .video import raster
from .video import secam as secam_mod
from .video.params import VideoParams

_INDEX_KEYS = ("base", "nxt", "prv", "vy", "al", "ar", "lut_row")
_FLOAT_KEYS = ("burst", "vswitch", "cos0", "sin0")


def resolve_device(device) -> torch.device:
    """The torch device for `device`; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev


class Encoder:
    def __init__(self, mode: str | VidConfig, sample_rate: int,
                 pixel_rate: int = 0, source=None,
                 frames_per_block: int = 1, vfilter: bool = False,
                 offset: int = 0, devices=None, device="cuda",
                 fm_direct_trig: bool = False, a2stereo: bool = False,
                 secam_exact: bool | None = None, **unported):
        for name, value in unported.items():
            if value:
                raise NotImplementedError(f"{name} is not ported yet")
        if offset:
            raise NotImplementedError("offset is not ported yet")
        if devices is not None:
            raise NotImplementedError("multiple devices are not ported yet")
        if pixel_rate and int(pixel_rate) != int(sample_rate):
            raise NotImplementedError("--pixelrate is not ported yet")
        self.device = resolve_device(device)
        # cos/sin of the FM phase at every sample, not through the K=4
        # rotation chain (hacktv_tpu's switch of the same name)
        self._fm_direct = fm_direct_trig

        conf = get_mode(mode) if isinstance(mode, str) else mode
        if vfilter:
            conf = replace(conf, vfilter=True)
        _check_supported(conf)
        self.conf = conf
        self.params = VideoParams.create(conf, sample_rate, 0)
        self.out_params = self.params
        self.frames_per_block = frames_per_block
        p = self.params

        if source is None:
            source = TestCardSource(p.active_width, conf.active_lines)
        if not getattr(source, "stateless", False):
            raise NotImplementedError("moving-video sources are not ported "
                                      "yet")
        self.source = source
        self.vframe_x = (p.active_width - source.width) // 2
        self.vframe_y = (conf.active_lines - source.height) // 2

        # host statics, and their tensors on the device
        self.statics = raster.make_statics(p, self.vframe_x, source.width)
        self.dstatics = raster.to_device(self.statics, self.device)
        self._use_prv = bool(np.any(self.statics.sync_head))
        # the stream FIR's taps stay on the host: the kernel takes them by
        # value at each launch
        self.vf_taps = None
        if p.vfilter_ctaps is not None:
            self.vf_taps = tuple(
                torch.as_tensor(np.ascontiguousarray(a))
                for a in (p.vfilter_ctaps.real, p.vfilter_ctaps.imag))
        elif p.vfilter_taps is not None:
            self.vf_taps = (torch.as_tensor(p.vfilter_taps), None)

        self.halo_after = 1
        self.complex_out = conf.output_type == OutputType.COMPLEX
        self._init_audio(a2stereo)

        # SECAM chroma (src/video.c:3068-3233) on the device; the IIR's
        # cross-block carry is an f32 device scalar
        self.secam = None
        if conf.colour_mode == ColourMode.SECAM:
            if secam_exact:
                raise NotImplementedError(
                    "secam_exact (the host-exact SECAM chroma through the "
                    "native runtime) is not ported yet")
            if conf.secam_field_id:
                # the field-identification lines' full-span sawtooth takes
                # the carrier phase past 120 rad, where glibc's sinf/cosf
                # switch to a reduction that _sincosf_glibc does not have
                raise NotImplementedError(
                    "SECAM field-identification lines are not ported yet")
            self.secam = secam_mod.to_device(secam_mod.make_statics(
                p, self.vframe_x, source.width), self.device)
            self._secam_meta_cache: OrderedDict = OrderedDict()
            self._secam_z = {0: torch.zeros((), dtype=torch.float32,
                                            device=self.device)}

        # Reference output-ring size (src/video.c:3578, 4641-4688): at
        # startup the un-rendered next slots keep width 0 for one ring
        # cycle, so vbidata truncates the forward sync spill of the first
        # (olines - 1) lines there.  (raster, [SECAM], [vfilter], audio,
        # output)
        procs = [(3, False)]
        if self.secam is not None:
            procs.append((1, True))
        if self.vf_taps is not None:
            procs.append((2, True))
        procs += [(1, True), (1, False)]
        olines = 0
        prev_thread = True
        for i, (nl, th) in enumerate(procs):
            olines += nl - (0 if (i == 0 or th or prev_thread) else 1)
            prev_thread = th
        self._spill_warmup = olines - 1

        self._meta_cache: OrderedDict = OrderedDict()
        self._rgb_cache: tuple | None = None
        self._fpb_warned = False

    def _init_audio(self, a2stereo: bool):
        """Audio subcarriers (FM mono, the A2 second carrier and pilot,
        AM, NICAM), added after the video filter (src/video.c:4561)."""
        p = self.out_params
        dev = self.device
        self.audio = AudioChain(self.conf, p.sample_rate, p.width,
                                self.source, a2stereo=a2stereo)
        nlines = self.frames_per_block * p.lines
        nseg = self.audio.nseg
        self.fm_statics = None
        self.fm_win = None
        self.fm_dev_held = False
        c = self.audio.fm_mono
        if c is not None:
            self.fm_statics = audio_synth.make_fm_statics(
                c.num, c.den, c.level_int, c.kd, p.width, nseg, c.eps,
                device=dev)
            self.fm_statics.direct = self._fm_direct
            self.fm_win = self.audio.fm_win_config(c, nlines, dev)
            # channel mix + limiter + held values on the device, the int32
            # phase anchor a device scalar chained block to block; the A2
            # carriers' held values (0.95 scale) and carriers without an
            # exact phase modulus stay on the host, as in the JAX package
            self.fm_dev_held = self.fm_win is not None and not c.a2_scale
            if self.fm_dev_held:
                self._fm_xa: dict = {0: [None, torch.zeros(
                    (), dtype=torch.int32, device=dev)]}
                self._fm_xa_started = False
        self.fm_right_statics = None
        if self.audio.fm_right is not None:
            c = self.audio.fm_right
            self.fm_right_statics = audio_synth.make_fm_statics(
                c.num, c.den, c.level_int, c.kd, p.width, nseg, c.eps,
                device=dev)
            self.fm_right_win = self.audio.fm_win_config(c, nlines, dev)
            self.a2_statics = audio_synth.make_a2_statics(
                self.audio.a2_pilot, c.kd, p.width, device=dev)
        # fm_add mirrors a different contraction in a step with A2
        self._a2 = self.fm_right_statics is not None
        self.am_statics = None
        if self.audio.am_mono is not None:
            c = self.audio.am_mono
            self.am_statics = audio_synth.make_fm_statics(
                c.num, c.den, c.level_int, 0.0, p.width, nseg, c.eps,
                device=dev)
        self.nicam_statics = None
        if self.audio.nicam is not None:
            nt = self.audio.nicam
            self.nicam_statics = audio_synth.make_nicam_statics(
                nt["taps"], nt["num"], nt["den"], p.width, nt["timing"],
                device=dev)
            # the frame encoder runs on the device; its differential
            # state is a device scalar chained block to block
            st = self.nicam_statics
            spp = st.syms_per_period
            G = -(-nlines // st.period)
            L = (G + 4) * spp
            nf_max = (G * spp + st.nslot) // nicam_mod.NICAM_FRAME_SYMS + 12
            assert spp + nf_max * nicam_mod.NICAM_FRAME_SYMS <= L
            self.nicam_dev_statics = nicam_dev.make_dev_statics(
                nf_max, L, spp, device=dev)
        self.has_audio = any(x is not None for x in (
            self.fm_statics, self.fm_right_statics, self.am_statics,
            self.nicam_statics))

    # ------------------------------------------------------------------
    def _block_meta(self, block_no: int) -> dict:
        """Device metadata for stream lines [k0-1, k0+n+1) where k0 is the
        first line of block `block_no` and n = frames_per_block*lines."""
        p = self.params
        nlines = self.frames_per_block * p.lines
        k0 = block_no * nlines
        cyc = self._carrier_cycle_lines()
        key = (block_no % 2 if p.conf.lines % 2 else 0,
               k0 % cyc if cyc else 0, block_no == 0)
        hit = self._meta_cache.get(key)
        if hit is not None:
            self._meta_cache.move_to_end(key)
            return hit
        while len(self._meta_cache) > 256:
            self._meta_cache.popitem(last=False)
        meta = p.line_meta(k0 - 1, nlines + 1 + self.halo_after,
                           vframe_interlaced=self.source.interlaced,
                           vframe_x=self.vframe_x, vframe_y=self.vframe_y,
                           vframe_w=self.source.width,
                           vframe_h=self.source.height,
                           spill_warmup=self._spill_warmup)
        dev = {k: torch.as_tensor(meta[k].astype(np.int64),
                                  device=self.device) for k in _INDEX_KEYS}
        dev.update({k: torch.as_tensor(meta[k].astype(np.float32),
                                       device=self.device)
                    for k in _FLOAT_KEYS})
        self._meta_cache[key] = dev
        return dev

    def _carrier_cycle_lines(self) -> int:
        p = self.params
        if not p.cl_num:
            return 1
        return p.cl_num // math.gcd(p.width, p.cl_num)

    def _device_rgb(self, block_no: int):
        """Bit-exact host YUV conversion (f64, matching the reference's
        LUT build), uploaded once per distinct source frame."""
        rgb = self.source.read_video(block_no * self.frames_per_block)
        if self._rgb_cache is not None and self._rgb_cache[0] is rgb:
            return self._rgb_cache[1]
        if (self.frames_per_block > 1 and self._rgb_cache is not None
                and not self._fpb_warned):
            # one frame's planes cover the whole block
            self._fpb_warned = True
            print("hacktv_tpu_torch: warning: frames_per_block="
                  f"{self.frames_per_block} with a non-static source "
                  "repeats each block's first frame", file=sys.stderr)
        # SECAM's u/v are FM frequency offsets in deviation units
        # (src/video.c:3944-3953)
        yuv = tuple(torch.as_tensor(a, device=self.device)
                    for a in raster.rgb_to_yuv_host(
                        self.params, rgb, secam=self.secam is not None))
        self._rgb_cache = (rgb, yuv)
        return yuv

    # ------------------------------------------------------------------
    def _step(self, yuv, m: dict, first: float, audio: dict):
        """Synthesis + output filter + audio + int16 quantisation for one
        block of frames (plus halo lines).  Returns (samples, carries):
        the next block's device scalars by name ("fm_xa", "nicam_dsym",
        "secam_z")."""
        p = self.params
        W = p.width
        nlines = self.frames_per_block * p.lines
        n = nlines * W
        carry = {}

        block = raster.synth_block(
            self.dstatics, yuv, m["base"], m["nxt"], m["burst"],
            m["vswitch"], m["vy"], m["al"], m["ar"], m["cos0"], m["sin0"],
            m["lut_row"], m["prv"] if self._use_prv else None)
        if self.secam is not None:
            sm, z0 = audio["secam"]
            add, carry["secam_z"] = secam_mod.device_chroma_carrier(
                self.secam, sm, yuv[1], yuv[2], z0)
            block = secam_mod.render(self.secam, block, add, sm)
        block[0] *= first
        x = block.reshape(-1)

        yq = None
        if self.vf_taps is not None:
            # one pass over the stream for all taps (src/fir.c:529-615;
            # the VSB "scomplex" filter gives I and Q)
            taps_r, taps_i = self.vf_taps
            half = taps_r.shape[0] // 2
            xs = x[W - half: W - half + n + taps_r.shape[0] - 1]
            y = stream_fir(xs, taps_r, taps_i, n)
            if taps_i is not None:
                y, yq = y
                yq = yq.view(nlines, W)
            y = y.view(nlines, W)
        else:
            y = x[W: W + n].view(nlines, W)

        if not self.has_audio and not self.complex_out:
            return torch.clamp(torch.round(y), -32768, 32767).to(
                torch.int16), carry

        out_i = y
        out_q = yq if yq is not None else torch.zeros_like(out_i)
        if self.fm_statics is not None:
            d = audio["fm_mono"]
            if self.fm_dev_held:
                held = audio_synth.held_device(self.audio.fm_mono, d["pcm"],
                                               _LIM_HIST)
                fmargs, carry["fm_xa"] = audio_synth.fm_prepare(
                    self.fm_win, self.fm_statics, nlines, held, d["xa"],
                    d["lens_off"], d["offq"], d["offr"], d["col0"],
                    d["ctab"], d["stab"], adv=d["adv"])
            else:
                fmargs = self._fm_args(d, self.fm_win, self.fm_statics)
            out_i, out_q = audio_synth.fm_add(self.fm_statics, out_i, out_q,
                                              *fmargs, a2=self._a2)
        if self.fm_right_statics is not None:
            pp = audio["a2_pilot"]
            phi_extra = audio_synth.a2_pilot_phase(
                self.a2_statics, pp["c1"], pp["s1"], pp["c2"], pp["s2"],
                pp["base_phase"])
            out_i, out_q = audio_synth.fm_add(
                self.fm_right_statics, out_i, out_q,
                *self._fm_args(audio["fm_right"], self.fm_right_win,
                               self.fm_right_statics), phi_extra,
                a2=True)
        if self.am_statics is not None:
            am = audio["am_mono"]
            out_i, out_q = audio_synth.am_add(
                self.am_statics, out_i, out_q, am["seg_val"], am["seg_col"],
                am["c0"], am["s0"])
        if self.nicam_statics is not None:
            nc = audio["nicam"]
            signs_i, signs_q, carry["nicam_dsym"] = nicam_dev.signs_device(
                self.nicam_dev_statics, nc["pcm"], nc["dsym_in"],
                nc["famod16"], nc["base_off"], nc["nkeep"])
            out_i, out_q = audio_synth.nicam_add(
                self.nicam_statics, out_i, out_q, signs_i, signs_q,
                nc["offq"], nc["offr"], nc["cc_off"], audio["nicam_k0mod"])

        # int16 WRAP, not saturate: every reference mix into the line
        # buffer is a C `int16_t +=` (src/video.c:3261-3450), so an
        # over-range sum wraps.  round() is half to even, as jnp.round.
        def wrap(v):
            return ((torch.round(v).to(torch.int32) + 0x8000) & 0xFFFF) \
                - 0x8000
        iq = torch.stack([wrap(out_i), wrap(out_q)], dim=-1)
        return iq.to(torch.int16), carry

    def _fm_args(self, d: dict, fw, st) -> tuple:
        """fm_add's segment arguments of a host-held FM carrier: assembled
        on the device from held values (fm_prepare) when the carrier's
        phase modulus is exact, else as the host assembled them."""
        if fw is not None:
            return audio_synth.fm_prepare(
                fw, st, self.frames_per_block * self.params.lines,
                d["held"], d["xa"], d["lens_off"], d["offq"], d["offr"],
                d["col0"], d["ctab"], d["stab"])
        return (d["seg_val"], d["seg_base"], d["seg_col"], d["ctab"],
                d["stab"], None)

    def _host_fm(self, carrier, k0: int, nlines: int, fw) -> dict:
        """Host side of an FM carrier whose held values are computed on
        the host (AudioChain.fm_compact_block or fm_block), as tensors
        where the step reads them on the device."""
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                      device=self.device)
        if fw is not None:
            d = self.audio.fm_compact_block(carrier, k0, nlines, fw)
            d["xa"] = torch.tensor(d["xa"], dtype=torch.int32,
                                   device=self.device)
            for k in ("held", "col0", "ctab", "stab"):
                d[k] = t(d[k])
        else:
            d = self.audio.fm_block(carrier, k0, nlines)
            for k in ("seg_val", "seg_base", "seg_col", "ctab", "stab"):
                d[k] = t(d[k])
        return d

    def _audio_args(self, block_no: int) -> dict:
        """Host audio-rate computation -> per-block arguments (host ints
        and numpy offsets; the PCM window and tables as tensors)."""
        nlines = self.frames_per_block * self.params.lines
        k0 = block_no * nlines
        # With the video filter enabled the audio process consumes the
        # filter's one-line-delayed stream, so the audio timeline runs one
        # line ahead of the output line it lands on (src/video.c:4675-4688)
        a_k0 = k0 + (1 if self.conf.vfilter else 0)
        args = {}
        if self.fm_dev_held:
            c = self.audio.fm_mono
            if not self._fm_xa_started and block_no not in self._fm_xa:
                # first encoded block may start mid-stream: seed the
                # anchor with the host-exact pre-span sum
                i0b = self.audio.fm_dev_i0(a_k0, self.fm_win)
                self._fm_xa[block_no] = [i0b, torch.tensor(
                    self.audio.fm_dev_seed_xa(c, i0b, self.fm_win),
                    dtype=torch.int32, device=self.device)]
            self._fm_xa_started = True
            if block_no not in self._fm_xa \
                    or self._fm_xa[block_no][1] is None:
                raise RuntimeError(
                    "FM blocks must be encoded sequentially (no device "
                    f"phase anchor for block {block_no})")
            exp_i0, xa = self._fm_xa[block_no]
            dct, i0, i0n = self.audio.fm_compact_block_dev(
                c, a_k0, nlines, self.fm_win, xa)
            if exp_i0 is not None and exp_i0 != i0:
                raise RuntimeError("FM device anchor mismatch (expected "
                                   f"i0 {exp_i0}, got {i0})")
            self._fm_xa[block_no + 1] = [i0n, None]
            self._fm_xa.pop(block_no - 2, None)
            for k in ("pcm", "col0", "ctab", "stab"):
                dct[k] = torch.as_tensor(dct[k], device=self.device)
            args["fm_mono"] = dct
        elif self.fm_statics is not None:
            args["fm_mono"] = self._host_fm(self.audio.fm_mono, a_k0, nlines,
                                            self.fm_win)
        if self.fm_right_statics is not None:
            args["fm_right"] = self._host_fm(self.audio.fm_right, a_k0,
                                             nlines, self.fm_right_win)
            args["a2_pilot"] = {
                k: torch.as_tensor(v, device=self.device)
                for k, v in self.audio.pilot_block(a_k0, nlines).items()}
        if self.am_statics is not None:
            args["am_mono"] = {
                k: torch.as_tensor(np.ascontiguousarray(v), device=self.device)
                for k, v in self.audio.am_block(self.audio.am_mono, a_k0,
                                                nlines).items()}
        if self.nicam_statics is not None:
            nc = self.audio.nicam_device_block(
                a_k0, nlines, self.nicam_statics, self.nicam_dev_statics,
                self._nicam_dev_fn)
            for k in ("pcm", "cc_off"):
                nc[k] = torch.as_tensor(nc[k], device=self.device)
            args["nicam"] = nc
            args["nicam_k0mod"] = a_k0 % self.nicam_statics.period
        if self.secam is not None:
            args["secam"] = self._secam_args(block_no)
        return args

    def _secam_args(self, block_no: int):
        """The block's SECAM metadata on the device and the IIR carry.
        The per-line metadata is periodic in the stream line with period
        6 frames (dr parity: 2, carrier phase sign: 3); block 0 is special
        (clamped pre-stream rows).  Building a new key is a Python loop
        over the block's lines."""
        nlines = self.frames_per_block * self.params.lines
        k0 = block_no * nlines
        key = k0 % (6 * self.conf.lines) if k0 > 0 else -1
        sm = self._secam_meta_cache.get(key)
        if sm is not None:
            self._secam_meta_cache.move_to_end(key)
        else:
            nm = secam_mod.block_meta(
                self.params, k0 - 1, nlines + 1 + self.halo_after, nlines,
                self.vframe_y, self.source.height)
            sm = secam_mod.meta_to_device(nm, self.device)
            while len(self._secam_meta_cache) > 64:
                self._secam_meta_cache.popitem(last=False)
            self._secam_meta_cache[key] = sm
        if block_no not in self._secam_z:
            raise RuntimeError("SECAM blocks must be encoded sequentially "
                               f"(no IIR carry for block {block_no})")
        return sm, self._secam_z[block_no]

    def _nicam_dev_fn(self, *a):
        """signs_device on this encoder's statics (the seek catch-up)."""
        return nicam_dev.signs_device(self.nicam_dev_statics, *a)

    def encode_block_device(self, block_no: int) -> torch.Tensor:
        """Synthesise one block of frames_per_block frames; returns a
        device tensor: int16 [nlines, W] for real output modes, or int16
        [nlines, W, 2] (I, Q) for complex/audio modes."""
        yuv = self._device_rgb(block_no)
        m = self._block_meta(block_no)
        first = 0.0 if block_no == 0 else 1.0
        out, carry = self._step(yuv, m, first, self._audio_args(block_no))
        if self.fm_dev_held:
            self._fm_xa[block_no + 1][1] = carry["fm_xa"]
        if self.nicam_statics is not None:
            self.audio.nicam_dev_dsym(carry["nicam_dsym"])
        if self.secam is not None:
            self._secam_z[block_no + 1] = carry["secam_z"]
            self._secam_z.pop(block_no - 2, None)
        return out

    @property
    def frame_samples(self) -> int:
        """Output samples per frame."""
        return self.out_params.frame_samples

    def encode_block(self, block_no: int) -> np.ndarray:
        """Host int16 samples for one block: [n] for real output modes,
        interleaved [n, 2] I/Q for complex/audio modes."""
        return self.collect_block(block_no,
                                  self.encode_block_device(block_no))

    def collect_block(self, block_no: int, dev: torch.Tensor) -> np.ndarray:
        """Device tensor -> host int16 samples.  Splitting dispatch
        (encode_block_device) from collection lets a caller overlap the
        copy of block b with the device compute of block b+1."""
        a = dev.cpu().numpy()
        if a.ndim == 3:
            return a.reshape(-1, 2)
        return a.reshape(-1)

    def encode_frame(self, frame_no: int) -> np.ndarray:
        """Single-frame convenience API (frames_per_block must be 1)."""
        assert self.frames_per_block == 1
        return self.encode_block(frame_no)


def _check_supported(conf: VidConfig) -> None:
    """Raise NotImplementedError for what the port does not cover yet."""
    if conf.mac_mode is not None:
        raise NotImplementedError("MAC modes are not ported yet")
    if conf.colour_mode not in (ColourMode.PAL, ColourMode.NTSC,
                                ColourMode.SECAM, ColourMode.MONOCHROME):
        raise NotImplementedError(
            f"colour mode {conf.colour_mode.name} is not ported yet")
    if conf.modulation == Modulation.FM:
        raise NotImplementedError("FM video modes are not ported yet")
    if conf.s_video:
        raise NotImplementedError("S-Video is not ported yet")
    if conf.frame_orientation:
        raise NotImplementedError("rotated frame orientations are not "
                                  "ported yet")
    if conf.offset or conf.swap_iq:
        raise NotImplementedError("offset and swap_iq are not ported yet")
