"""Top-level encoder: source frames -> block synthesis on the device ->
int16 samples.

Port of hacktv_tpu/encoder.py for the raster modes (PAL, NTSC, SECAM,
monochrome, field-sequential colour, the rotated frames of Baird 30 and
NBTV, S-Video) with the video filter, FM mono and A2 stereo sound, AM
sound and NICAM-728 (PAL-I, the flagship chain, PAL-B/G, SECAM-L, D/K,
NTSC-M + VSB `--filter`, the 405-line modes, composite with the low-pass
`--filter`), FM video (the satellite modes `pal-fm`, `ntsc-fm`,
`secam-fm`, and `ntsc-bs` with DANCE digital sound), the VBI services
and the line scramblers (Videocrypt I/II/S, Syster with and without
cut-and-rotate, Discret 11, the Syster audio inversion), the pixel-rate
resampler (`pixel_rate`), and the RF tail every mode shares: swap-IQ,
the frequency offset and the passthru stream; a raw baseband file may
replace the raster.  The source is the test card or a moving one (av/:
raw RGB32 files, ffmpeg, OpenCV, sequences, the fit geometry), whose
frames convert on the device through the reference's 16M-entry LUT.  A
block of `frames_per_block` whole frames, plus one halo line each side
for filter continuity, is synthesised as a sequence of tensor ops on one
device:

    raster (video/raster.py) -> SECAM chroma and render (video/secam.py)
    -> services and scramblers (services/) -> resampler (ops/resampler.py)
    -> stream FIR (ops/stream_fir.py, the CUDA kernel on a card) -> FM
    and A2 sound carriers, AM sound (audio/synth.py) -> NICAM
    (audio/nicam_dev.py, audio/synth.py) -> DANCE (audio/synth.py) -> FM
    video, swap-IQ, offset (rf/ops.py) -> int16 (+ passthru)

FM video runs the reference's serial int32 recurrence on the host
(runtime.FmCarrierExact, in `collect_block`) unless swap-IQ, the offset
or passthru follow it; then the device closed form runs
(rf_ops.fm_video_modulate).  The FM-video modes' sound carrier is the
host-exact one too, and their SECAM chroma the host-exact path
(video/secam.py chroma_block_host, carrier_addin_host).

The stream-line counter `k` is the only state: k=0 is the first rendered
line, (frame 1, line 1), with zero filter history at the stream start.
The FM phase anchor, the FM-video phase, the NICAM differential state
and the SECAM IIR state are device scalars (the host-exact carriers and
IIR host state) chained block to block, and the scramblers' PRBS state
and DANCE's differential state live on the host, so blocks must be
encoded in order.  `checkpoint` writes those carries out (numpy only) and
`load_checkpoint` resumes a fresh encoder from them, on either device.

Metadata, line tables, taps and the audio window bookkeeping stay host
numpy.  Options that are not ported yet raise NotImplementedError.

With `devices` (a list of devices, repeats allowed) the step is split in
two (shard.py): the block stage (the moving source's conversion, the FM
segment assembly, NICAM's bit pipeline: the block's [nlines] vectors)
runs once per distinct device, and the row stage (everything from the
raster to the int16 pack) once per shard, on the shard's lines and the
halo rows its stages read, on the shard's device.  The output is the
single device's, byte for byte.
"""

from __future__ import annotations

import copy
import math
import pickle
import sys
import time
from collections import OrderedDict
from dataclasses import replace

import numpy as np
import torch

from . import runtime
from . import shard
from . import step_graph
from . import telemetry
from . import transfer
from .audio import nicam as nicam_mod
from .audio import nicam_dev
from .audio import synth as audio_synth
from .audio.chain import _LIM_HIST, AudioChain
from .av import frame_ops
from .av.testcard import TestCardSource
from .config.standards import (ColourMode, Modulation, OutputType, VidConfig,
                               get_mode)
from .ops import resampler
from .ops.stream_fir import bind as bind_stream_fir
from .ops.stream_fir import stream_fir
from .rf import ops as rf_ops
from .services import window_arrays
from .services.acp import ACP
from .services.cc608 import CC608
from .services.sis import SiS
from .services.syster import D11, Syster, SysterCNR
from .services.teletext import Teletext
from .services.videocrypt import Videocrypt
from .services.videocrypts import VideocryptS
from .services.vitc import VITC
from .services.vits import VITS
from .services.wss import WSS
from .video import raster
from .video import secam as secam_mod
from .video.params import VideoParams

_INDEX_KEYS = ("base", "nxt", "prv", "vy", "al", "ar", "lut_row", "fsc",
               "fscf")
_FLOAT_KEYS = ("burst", "vswitch", "cos0", "sin0")
# lines each service holds in the reference's output ring
# (src/video.c:4215-4359): the scramblers delay by up to a field
_SVC_NLINES = {"VITS": 1, "WSS": 1, "Videocrypt": 2, "VideocryptS": 126,
               "Syster": 345, "SysterCNR": 2, "D11": 2, "ACP": 1, "VITC": 1,
               "CC608": 1, "SiS": 1, "Teletext": 1}


class Encoder:
    @telemetry.spanned("setup.encoder")
    def __init__(self, mode: str | VidConfig, sample_rate: int,
                 pixel_rate: int = 0, source=None,
                 frames_per_block: int = 1, vfilter: bool = False,
                 offset: int = 0, swap_iq: bool = False, devices=None,
                 device="cuda", fm_direct_trig: bool = False,
                 a2stereo: bool = False, passthru: str | None = None,
                 raw_bb_file: str | None = None, raw_bb_blanking: int = 0,
                 raw_bb_white: int = 0x300,
                 secam_exact: bool | None = None, wss: str | None = None,
                 teletext: str | None = None, vits: bool = False,
                 vitc: bool = False, cc608: bool = False, acp: bool = False,
                 sis: str | None = None, teletext_clock=None,
                 videocrypt: str | None = None,
                 videocrypt2: str | None = None,
                 videocrypts: str | None = None, syster: str | None = None,
                 systercnr: str | None = None, syster_key_table: int = 0,
                 d11: str | None = None, systeraudio: bool = False,
                 **unported):
        for name, value in unported.items():
            if value:
                raise NotImplementedError(f"{name} is not ported yet")
        if devices is not None:
            # the first shard's device holds the host state's tensors
            devices = shard.resolve_devices(devices)
            device = devices[0]
        self.device = transfer.resolve_device(device)
        # cos/sin of the FM phase at every sample, not through the K=4
        # rotation chain (hacktv_tpu's switch of the same name)
        self._fm_direct = fm_direct_trig

        conf = get_mode(mode) if isinstance(mode, str) else mode
        if vfilter or offset or swap_iq:
            conf = replace(conf, vfilter=conf.vfilter or vfilter,
                           offset=conf.offset or int(offset),
                           swap_iq=conf.swap_iq or swap_iq)
        if conf.mac_mode is not None:
            # the packet-multiplex raster has its own encoder
            raise ValueError(f"{conf.mac_mode.name}-MAC modes take "
                             "video.mac.MacEncoder; create_encoder picks "
                             "it by mode")
        self.conf = conf
        self.params = VideoParams.create(conf, sample_rate, pixel_rate)
        self.frames_per_block = frames_per_block
        p = self.params
        # line-axis sharding over `devices` (shard.py); one device is the
        # unsharded block
        self._plan = None
        if devices is not None and len(devices) > 1:
            self._plan = shard.ShardPlan.create(
                devices, frames_per_block * conf.lines)

        # Rational pixel -> sample video resampler (src/fir.c:392-428,
        # src/video.c:3627-3651): the raster runs at pixel_rate, and the
        # stream is resampled to sample_rate before the video filter and
        # the sound carriers
        self.resampler = None
        self.out_params = p
        if pixel_rate and int(pixel_rate) != int(sample_rate):
            self.out_params = VideoParams.create(conf, sample_rate, 0)
            rs = resampler.Resampler.create(int(sample_rate),
                                            int(pixel_rate))
            self.resampler = resampler.make_block_statics(
                rs, p.width, self.out_params.width,
                frames_per_block * conf.lines, halo_lines=1)
            if self._plan is not None:
                # a shard's resample: the last shard's ends where the
                # block's does; an inner shard's reads a line further, so
                # that the lines it keeps never meet the zeros past its
                # window
                ns = self._plan.lines_per_shard
                self._rs_shard = tuple(resampler.make_block_statics(
                    rs, p.width, self.out_params.width, ns, halo_lines=h)
                    for h in (1, 2))
            if conf.colour_mode == ColourMode.SECAM:
                # hacktv_tpu lays the SECAM chroma out at the output width
                # over a raster at the pixel width, and fails in encoding
                raise NotImplementedError(
                    "SECAM with --pixelrate is not supported: the SECAM "
                    "chroma is laid out at the output width, not the "
                    "pixel width")

        # Vertical-scan modes (Baird 30, NBTV) take the frame with its
        # sides swapped and rotate it to scan order (src/hacktv.c:1520-1526,
        # src/video.c:4881-4893)
        if source is None:
            if (conf.frame_orientation & 3) in (1, 3):
                source = TestCardSource(conf.active_lines, p.active_width)
            else:
                source = TestCardSource(p.active_width, conf.active_lines)
        if conf.frame_orientation:
            source = _OrientedSource(source, conf.frame_orientation)
        self.source = source
        # a moving source: any source whose frames are not addressable by
        # index (the test card is)
        moving = not getattr(source, "stateless", False)
        self.vframe_x = (p.active_width - source.width) // 2
        self.vframe_y = (conf.active_lines - source.height) // 2

        # host statics, and their tensors on the device
        self.statics = raster.make_statics(p, self.vframe_x, source.width)
        self.dstatics = raster.to_device(self.statics, self.device)
        self._use_prv = bool(np.any(self.statics.sync_head))
        # the stream FIR's taps stay on the host: the kernel takes them by
        # value at each launch
        op = self.out_params
        self.vf_taps = None
        if op.vfilter_ctaps is not None:
            self.vf_taps = tuple(
                torch.as_tensor(np.ascontiguousarray(a))
                for a in (op.vfilter_ctaps.real, op.vfilter_ctaps.imag))
        elif op.vfilter_taps is not None:
            self.vf_taps = (torch.as_tensor(op.vfilter_taps), None)
        if self.vf_taps is not None and self.device.type == "cuda":
            # the kernels' library is built and loaded at set-up, not in
            # the first block
            bind_stream_fir()

        # VBI data services, in the reference's registration order
        # (src/video.c:4215-4359): vits, wss, the scramblers, acp, vitc,
        # cc608, sis, teletext.  The shared claimed mask depends on it.
        self.services = []
        dev = self.device
        if vits:
            self.services.append(VITS(
                p, conf.colour_mode == ColourMode.PAL,
                fused_mix=self.statics.carrier_rows is not None, device=dev))
        if wss:
            self.services.append(WSS(p, wss, device=dev))
        if videocrypt or videocrypt2:
            self.services.append(Videocrypt(p, videocrypt, videocrypt2,
                                            device=dev))
        if videocrypts:
            self.services.append(VideocryptS(p, videocrypts, device=dev))
        if syster:
            self.services.append(Syster(p, syster, cnr=bool(systercnr),
                                        key_table=syster_key_table,
                                        device=dev))
        elif systercnr:
            self.services.append(SysterCNR(p, systercnr,
                                           key_table=syster_key_table,
                                           device=dev))
        if d11:
            self.services.append(D11(p, d11, device=dev))
        if acp:
            self.services.append(ACP(p, device=dev))
        if vitc:
            self.services.append(VITC(p, device=dev))
        if cc608:
            self.services.append(CC608(p, source=self.source, device=dev))
        if sis:
            # the sis process reads the sound through a chain of its own:
            # the audio line process trails it by 1 line plus the
            # threaded video filter's window (src/video.c:4675-4688)
            lag = 1
            nt = (len(p.vfilter_ctaps) if p.vfilter_ctaps is not None else
                  len(p.vfilter_taps) if p.vfilter_taps is not None else 0)
            if nt:
                lag += 1 + (nt // 2 + p.width - 1) // p.width
            sis_chain = AudioChain(conf, p.sample_rate, p.width, self.source,
                                   systeraudio=systeraudio)
            self.services.append(SiS(p, sis, sis_chain, lag, device=dev))
        if teletext:
            self.services.append(Teletext(p, teletext, clock=teletext_clock,
                                          device=dev))
        # services that read lines ahead (the Syster shuffle: up to 344)
        # extend the bottom halo of each synthesised block
        self.halo_after = max([1] + [getattr(s, "lookahead", 1)
                                     for s in self.services])
        # only VITS's chroma part reads the line carrier
        self._services_lut = any(getattr(s, "colour", False)
                                 for s in self.services)
        # S-Video puts luma and chroma on two channels, like a complex
        # stream (src/video.c:3032: chroma written to the second channel)
        self.complex_out = (conf.output_type == OutputType.COMPLEX
                            or conf.s_video)
        if conf.s_video and self.resampler is not None:
            raise NotImplementedError(
                "--pixelrate with --s-video is not supported")
        self._init_audio(a2stereo, systeraudio)

        # FM video modulation (src/video.c:4564-4585).  The reference's
        # int32 phase recurrence truncation-walks by a content-dependent
        # ~1e-8 rad/sample that a closed form cannot reproduce, so the
        # host-exact serial recurrence runs the modulator where nothing
        # follows it on the device; with swap-IQ, the offset or passthru
        # the device closed form runs, its phase carry a device scalar
        self.fm_video_statics = None
        self.fm_video_exact = None
        self._fm_ed_frame = None
        if conf.modulation == Modulation.FM:
            if not conf.swap_iq and not conf.offset and passthru is None:
                self.fm_video_exact = runtime.FmCarrierExact(
                    0.0, conf.fm_deviation, p.sample_rate,
                    int(round(32767 * conf.fm_level * conf.level)))
            else:
                self.fm_video_statics = rf_ops.make_fm_video_statics(
                    conf.fm_deviation, conf.fm_level * conf.level,
                    p.sample_rate, conf.lines)
                self._fm_r = {0: torch.zeros((), dtype=torch.int64,
                                             device=self.device)}
            # frame-locked triangular energy dispersal
            # (src/video.c:4573-4581): exactly one frame long
            self._fm_ed_frame = rf_ops.fm_energy_dispersal_frame(
                conf.fm_energy_dispersal, self.out_params.width,
                conf.lines) if conf.fm_energy_dispersal else None
            if self._fm_ed_frame is not None \
                    and self.fm_video_statics is not None:
                self._fm_ed_dev = torch.as_tensor(
                    self._fm_ed_frame.astype(np.int32), device=self.device)

        # complex frequency offset (src/video.c:4592-4605)
        self.offset_statics = None
        if conf.offset:
            self.offset_statics = rf_ops.make_offset_statics(
                conf.offset, p.sample_rate, self.out_params.width,
                device=self.device)

        # SECAM chroma (src/video.c:3068-3233): the device program by
        # default, its IIR's cross-block carry an f32 device scalar; the
        # host-exact path (the native runtime) with secam_exact, the
        # default of the FM-video modes, whose FM phase would integrate
        # the device program's rare 1-LSB round flips
        self.secam = None
        self.secam_device = False
        if conf.colour_mode == ColourMode.SECAM:
            st = secam_mod.make_statics(p, self.vframe_x, source.width)
            # the field-identification lines' full-span sawtooth, and
            # saturated moving colour, take the carrier phase past 120 rad
            self.secam = secam_mod.to_device(
                st, self.device, large=conf.secam_field_id or moving)
            if secam_exact is None:
                secam_exact = conf.modulation == Modulation.FM
            self.secam_device = not secam_exact
            if self.secam_device and self.device.type == "cuda":
                secam_mod.bind()        # built at set-up, as the FIR's
            self._secam_meta_cache: OrderedDict = OrderedDict()
            if self.secam_device:
                self._secam_z = {0: torch.zeros((), dtype=torch.float32,
                                                device=self.device)}
            else:
                # the reference's f64 IIR state (ix, iy), carried across
                # the stream (src/fir.c:710-740)
                self._secam_iir = {0: (0.0, 0.0)}
                self._secam_lut = secam_mod.carrier_lut(st, p.pixel_rate)
                self._secam_host_cache: dict = {}

        # raw baseband replay (src/video.c:2406-2445) replaces the raster;
        # passthru (src/video.c:3517-3541) adds an int16 I/Q stream just
        # before the output
        self.raw_bb = None
        if raw_bb_file is not None:
            self.raw_bb = _RawBBReader(raw_bb_file, p.width, raw_bb_blanking,
                                       raw_bb_white, p.blanking_level,
                                       p.white_level)
        self.passthru = None
        if passthru is not None:
            self.passthru = _PassthruReader(passthru)

        # Reference output-ring size (src/video.c:3578, 4641-4688): at
        # startup the un-rendered next slots keep width 0 for one ring
        # cycle, so vbidata truncates the forward sync spill of the first
        # (olines - 1) lines there.  (raster or raw baseband, [SECAM],
        # [services], [resampler], [vfilter], audio, [FM video], [swap],
        # [offset], [passthru], output; the services' lines are
        # _SVC_NLINES)
        procs = [(1 if raw_bb_file else 3, False)]
        if self.secam is not None:
            procs.append((1, True))
        procs += [(_SVC_NLINES[type(s).__name__], False)
                  for s in self.services]
        if self.resampler is not None:
            procs.append((2, True))
        if self.vf_taps is not None:
            procs.append((2, True))
        procs.append((1, True))
        if conf.modulation == Modulation.FM:
            procs.append((1, True))
        if conf.swap_iq:
            procs.append((1, False))
        if conf.offset:
            procs.append((1, True))
        if self.passthru is not None:
            procs.append((1, False))
        procs.append((1, False))
        olines = 0
        prev_thread = True
        for i, (nl, th) in enumerate(procs):
            olines += nl - (0 if (i == 0 or th or prev_thread) else 1)
            prev_thread = th
        self._spill_warmup = olines - 1

        self._meta_cache: OrderedDict = OrderedDict()
        self._rgb_cache: tuple | None = None
        self._fpb_warned = False
        # moving sources convert on the device through the 16M-entry LUT
        # (held on the device once per encoder); with several frames a
        # block, fpb + 2 frames a block (a leading halo frame and a
        # trailing lookahead) are stacked and gathered by absolute row.
        # SECAM keeps single-frame planes for its chroma program.
        self._dev_convert = self._use_dev_convert()
        self._multi_frame = (self._dev_convert and frames_per_block > 1
                             and self.secam is None)
        self._nf = frames_per_block + 2
        self._frame_cache: dict = {}
        self._yuv_lut = None

        # the block's synthesised rows: the halo line before it, its
        # lines, and halo_after lines past it
        self._rows = frames_per_block * conf.lines + 1 + self.halo_after
        self._windows = None
        self._replicas: dict = {}
        self._moved: dict = {}
        # with shard_timing on (and CUDA devices), each row stage is
        # bracketed by CUDA events: shard_events [(shard, start, end)]
        self.shard_timing = False
        self.shard_events: list = []
        if self._plan is not None:
            # rows a shard computes exactly past its lines: the halo line
            # after them (the stream FIR), and the resampler's lines
            self._windows = self._plan.windows(
                self._rows, 2 + (2 if self.resampler is not None else 0),
                self.halo_after)
        # an unsharded step on a card replays as a CUDA graph wherever
        # its host inputs repeat (step_graph.py)
        self._graphs = (step_graph.StepGraphs(self.device)
                        if self.device.type == "cuda" and self._plan is None
                        else None)

    def _init_audio(self, a2stereo: bool, systeraudio: bool):
        """Audio subcarriers (FM mono, the A2 second carrier and pilot,
        AM, NICAM, DANCE), added after the video filter
        (src/video.c:4561)."""
        p = self.out_params
        dev = self.device
        self.audio = AudioChain(self.conf, p.sample_rate, p.width,
                                self.source, systeraudio=systeraudio,
                                a2stereo=a2stereo)
        nlines = self.frames_per_block * p.lines
        nseg = self.audio.nseg
        self.fm_statics = None
        self.fm_win = None
        self.fm_dev_held = False
        self.fm_exact = None
        c = self.audio.fm_mono
        if c is not None and self.conf.modulation == Modulation.FM:
            # FM-video (satellite) modes integrate the sound carrier's
            # sub-LSB truncation bias into a phase ramp, so it is the
            # reference's int32 recurrence itself, serial on the host
            # (src/video.c:2218-2276)
            self.fm_exact = runtime.FmCarrierExact(
                c.frequency, c.deviation, p.sample_rate, c.level_int)
        elif c is not None:
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
        # DANCE (ntsc-bs): NICAM's pulse-matrix synthesis of a sign stream
        # that the host codes (audio/dance.py)
        self.dance_statics = None
        if self.audio.dance is not None:
            dt = self.audio.dance
            self.dance_statics = audio_synth.make_nicam_statics(
                dt["taps"], dt["num"], dt["den"], p.width, dt["timing"],
                device=dev)
        self.has_audio = any(x is not None for x in (
            self.fm_statics, self.fm_right_statics, self.am_statics,
            self.nicam_statics, self.dance_statics))

    # ------------------------------------------------------------------
    def _block_meta(self, block_no: int) -> dict:
        """Device metadata for stream lines [k0-1, k0+n+1) where k0 is the
        first line of block `block_no` and n = frames_per_block*lines."""
        p = self.params
        nlines = self.frames_per_block * p.lines
        k0 = block_no * nlines
        cyc = self._carrier_cycle_lines()
        # field-sequential colour cycles its B/G/R fields over 3 frames
        fsc3 = ((1 + k0 // p.conf.lines) % 3
                if self.statics.fsc_mode is not None else 0)
        key = (block_no % 2 if p.conf.lines % 2 else 0,
               k0 % cyc if cyc else 0, block_no == 0, fsc3)
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
        if self._multi_frame:
            # absolute stacked row: f_local (H + 1) + row, or + H for the
            # frame's fallback row; the per-line frame offsets repeat
            # under the same cache key
            L = p.conf.lines
            H = self.source.height
            ks = np.maximum(k0 - 1 + np.arange(len(meta["vy"]),
                                               dtype=np.int64), 0)
            first_f = max((k0 - 1) // L, 0)
            f_local = np.clip(ks // L - first_f, 0, self._nf - 1)
            vy0 = meta["vy"]
            meta = dict(meta)
            meta["vy"] = np.where(vy0 >= 0, f_local * (H + 1) + vy0,
                                  f_local * (H + 1) + H)
        dev = {k: transfer.upload(meta[k].astype(np.int64), self.device)
               for k in _INDEX_KEYS}
        dev.update({k: transfer.upload(meta[k].astype(np.float32),
                                       self.device)
                    for k in _FLOAT_KEYS})
        self._meta_cache[key] = dev
        return dev

    def _carrier_cycle_lines(self) -> int:
        p = self.params
        if not p.cl_num:
            return 1
        return p.cl_num // math.gcd(p.width, p.cl_num)

    def _device_rgb(self, block_no: int):
        """The block's picture on the device.  A moving source's frames go
        up as uint8, with the LUT they convert through in the step: a
        stack of the block's frames (multi-frame), or its first frame.
        Otherwise the host conversion (f64, bit-exact with the
        reference's LUT build), uploaded once per distinct source
        frame."""
        if self._multi_frame:
            # frames are read per block window in ascending order (the
            # ffmpeg pipe decodes monotonically)
            if self._rgb_cache is not None \
                    and self._rgb_cache[0] == ("blk", block_no):
                return self._rgb_cache[1]
            stack = np.stack([self._read_frame(block_no, j)
                              for j in range(self._nf)])
            dev = (self._lut(), transfer.upload(stack, self.device))
            self._rgb_cache = (("blk", block_no), dev)
            return dev
        rgb = self.source.read_video(block_no * self.frames_per_block)
        if self._rgb_cache is not None and self._rgb_cache[0] is rgb:
            return self._rgb_cache[1]
        if (self.frames_per_block > 1 and self._rgb_cache is not None
                and not self._fpb_warned):
            # one frame's planes cover the whole block
            self._fpb_warned = True
            print("hacktv_tpu_torch: warning: frames_per_block="
                  f"{self.frames_per_block} with a non-static source "
                  "repeats each block's first frame; use "
                  "--frames-per-block 1 for moving video", file=sys.stderr)
        if self._dev_convert:
            dev = (self._lut(), transfer.upload(np.ascontiguousarray(rgb),
                                                self.device))
            self._rgb_cache = (rgb, dev)
            return dev
        if self.statics.fsc_mode is not None:
            # field-sequential colour: one grey plane per channel, in the
            # order of the fsc value 0=B, 1=G, 2=R (the reference
            # replicates the selected byte, src/video.c:2989-2994)
            planes = [raster.rgb_to_yuv_host(
                self.params, np.repeat(rgb[..., ch:ch + 1], 3, axis=-1))[0]
                for ch in (2, 1, 0)]
            zero = np.zeros_like(planes[0])
            host = (np.stack(planes), zero, zero)
        else:
            # SECAM's u/v are FM frequency offsets in deviation units
            # (src/video.c:3944-3953)
            host = raster.rgb_to_yuv_host(self.params, rgb,
                                          secam=self.secam is not None)
        yuv = tuple(transfer.upload(a, self.device) for a in host)
        self._rgb_cache = (rgb, yuv)
        # the host-exact SECAM chroma reads the host planes
        self._rgb_host_uv = host[1:]
        return yuv

    def _lut(self) -> torch.Tensor:
        """The conversion LUT on the device (SECAM's u/v are FM frequency
        offsets, src/video.c:3944-3953), built at first use."""
        if self._yuv_lut is None:
            self._yuv_lut = transfer.upload(
                raster.build_yuv_lut(self.params, self.secam is not None),
                self.device)
        return self._yuv_lut

    def _read_frame(self, block_no: int, j: int) -> np.ndarray:
        """Frame first_f + j of block block_no, from the block-window
        cache.  Block b reads frame fpb b - 1 again as its halo, and
        sources like the ffmpeg pipe decode monotonically and reuse their
        frame buffer, so frames are copied on first read and evicted only
        below the window."""
        L = self.conf.lines
        k0 = block_no * self.frames_per_block * L
        first_f = max((k0 - 1) // L, 0)
        f = first_f + j
        hit = self._frame_cache.get(f)
        if hit is None:
            hit = np.array(self.source.read_video(f), copy=True)
            self._frame_cache[f] = hit
            for old_f in [x for x in self._frame_cache if x < first_f]:
                del self._frame_cache[old_f]
        return hit

    def _use_dev_convert(self) -> bool:
        """The device LUT conversion serves moving sources; the SECAM
        host-exact chroma needs the host u/v planes, field-sequential
        colour restacks planes, raw baseband has no picture, and the
        static test card converts once anyway."""
        if getattr(self.source, "stateless", False):
            return False
        if self.statics.fsc_mode is not None or self.raw_bb is not None:
            return False
        return self.secam is None or self.secam_device

    # ------------------------------------------------------------------
    def _step(self, yuv, m: dict, first: float, audio: dict):
        """Synthesis + output filter + audio + RF tail + int16
        quantisation for one block of frames (plus halo lines): the block
        stage, then the row stage over the whole block.  Returns
        (samples, carries): the next block's device scalars by name
        ("fm_xa", "nicam_dsym", "secam_z", "fm_r")."""
        blk = self._block_stage(yuv, audio)
        win = shard.whole_window(self.frames_per_block * self.params.lines,
                                 self._rows, self.device)
        out, carry = self._row_stage(blk, m, first, audio, win,
                                     self._hand_in(audio))
        return out, {**blk.carry, **carry}

    def _graphed_step(self, yuv, m: dict, first: float, audio: dict):
        """`_step` through the encoder's CUDA graphs (step_graph.py).
        The whole block's step reads SECAM's metadata on the device alone:
        its host copy, which serves a shard's window, is left out of the
        step's arguments and so of their key."""
        if "secam" in audio:
            audio = {**audio, "secam": {k: v for k, v in
                                        audio["secam"].items()
                                        if k != "host"}}
        return self._graphs(self._step, yuv, m, first, audio)

    def _hand_in(self, audio: dict) -> dict:
        """The block's serial carries into its first row stage: the SECAM
        IIR's z and the FM-video phase sum (device scalars)."""
        hand = {}
        if self.secam_device:
            hand["secam_z"] = audio["secam"]["z0"]
        if self.fm_video_statics is not None:
            hand["fm_r"] = audio["fm_r0"]
        return hand

    def _block_stage(self, yuv, audio: dict) -> "_BlockStage":
        """The block's replicated part on this encoder's device
        (_BlockStage): the moving source's conversion now, the rest where
        the row stage first reads it."""
        if self._dev_convert:
            yuv = raster.yuv_convert_device(*yuv)
            if self._multi_frame:
                yuv = raster.stack_planes(*yuv, self.statics.black_y)
        return _BlockStage(self, yuv, audio)

    def _row_stage(self, blk: "_BlockStage", m: dict, first: float,
                   audio: dict,
                   win: shard.Window, hand: dict):
        """The row chain over one window of the block (shard.Window): its
        synthesised rows [win.r0, win.r1), out to the samples of its lines
        [win.a, win.b).  `hand` holds the serial carries into the window
        (`_hand_in`); returns (samples, the carries out of it)."""
        p = self.params
        W = p.width
        nl = win.nlines
        n = nl * W
        whole = win.whole
        r0, r1, a = win.r0, win.r1, win.a
        rows = (lambda t: t) if whole else (lambda t: t[r0:r1])
        lines = (lambda t: t) if whole else (lambda t: t[a:a + nl])
        carry = {}
        yuv = blk.yuv
        mw = m if whole else {k: v[r0:r1] for k, v in m.items()}

        cblock = None
        if self.raw_bb is not None:
            block = rows(audio["rawbb"])
        else:
            # S-Video: luma and chroma on separate channels
            # (src/video.c:3032, 3219)
            block = raster.synth_block(
                self.dstatics, yuv, mw["base"], mw["nxt"], mw["burst"],
                mw["vswitch"], mw["vy"], mw["al"], mw["ar"], mw["cos0"],
                mw["sin0"], mw["lut_row"],
                mw["prv"] if self._use_prv else None, mw["fsc"],
                mw["fscf"], split_chroma=self.conf.s_video,
                stacked_h=(self.source.height + 1 if self._multi_frame
                           else 0))
            if self.conf.s_video:
                block, cblock = block
        if self.secam is not None:
            # counted always (secam.step_ns, secam.windows), a span while
            # tracing
            t_secam = time.perf_counter_ns()
            with telemetry.span("dispatch.step.secam"):
                sa = audio["secam"]
                sm = sa["meta"] if whole else secam_mod.window_meta(
                    sa["meta"], sa["host"], r0, r1, win.b)
                # S-Video: no luma band-reject; the carrier rides the C
                # channel (src/video.c:3206, 3219)
                luma = cblock is None
                rows_in = block if luma else cblock
                if self.secam_device:
                    rows_out, carry["secam_z"] = secam_mod.chroma_render(
                        self.secam, sm, yuv[1], yuv[2], hand["secam_z"],
                        rows_in, luma)
                else:
                    with telemetry.span("dispatch.step.secam.render"):
                        rows_out = secam_mod.render(
                            self.secam, rows_in,
                            rows(sa["add"]).to(torch.float32), sm, luma)
                if luma:
                    block = rows_out
                else:
                    cblock = rows_out
            telemetry.count("secam.step_ns",
                            time.perf_counter_ns() - t_secam)
            telemetry.count("secam.windows")
        if self.services:
            # the line's colour carrier for VITS's chroma part: the exact
            # LUT rows, the angle addition, or none (no colour carrier)
            lut = (raster.carrier_lut(self.dstatics, mw["cos0"], mw["sin0"],
                                      mw["lut_row"])
                   if self._services_lut else None)
            for svc, arr in zip(self.services, audio["services"]):
                if not whole:
                    arr = window_arrays(svc, arr, r0, r1)
                block = svc.apply(block, arr, lut)
        if r0 == 0:
            # the stream starts from zero filter history
            block[0] *= first
            if cblock is not None:
                cblock[0] *= first
        x = block.reshape(-1)

        if self.resampler is not None:
            # pixel -> sample rate resample of the stream, halo lines
            # included; from here on the stream is at the output width
            rs = (self.resampler if whole
                  else self._rs_shard[0 if win.last else 1])
            x = resampler.device_resample_block(rs, x)
            p = self.out_params
            W = p.width
            n = nl * W

        yq = None
        if self.vf_taps is not None:
            # one pass over the stream for all taps (src/fir.c:529-615;
            # the VSB "scomplex" filter gives I and Q)
            taps_r, taps_i = self.vf_taps
            y = self._stream_fir(x, taps_r, taps_i, W, n)
            if taps_i is not None:
                y, yq = y
                yq = yq.view(nl, W)
            y = y.view(nl, W)
        else:
            y = x[W: W + n].view(nl, W)
        if cblock is not None:
            # the S-Video C channel, through the low-pass when there is
            # one (the reference's video filter runs two channels,
            # src/video.c:4366); without real taps it replaces Q as it is
            xc = cblock.reshape(-1)
            if self.vf_taps is not None and self.vf_taps[1] is None:
                yq = self._stream_fir(xc, self.vf_taps[0], None, W, n)
            else:
                yq = xc[W: W + n]
            yq = yq.view(nl, W)

        if not self.has_audio and not self.complex_out:
            if self.passthru is not None:
                y = y + lines(audio["passthru"])[..., 0]
            return torch.clamp(torch.round(y), -32768, 32767).to(
                torch.int16), carry

        out_i = y
        out_q = yq if yq is not None else torch.zeros_like(out_i)
        if self.fm_statics is not None:
            out_i, out_q = audio_synth.fm_add(
                self.fm_statics, out_i, out_q,
                *_fm_window(blk.fm(), a, nl, whole), a2=self._a2)
        if self.fm_exact is not None:
            # the host-exact sound carrier of the FM-video modes, int16
            # (I, Q) per sample
            fx = lines(audio["fm_exact"])
            out_i = out_i + fx[..., 0]
            out_q = out_q + fx[..., 1]
        if self.fm_right_statics is not None:
            pp = {k: lines(v) for k, v in audio["a2_pilot"].items()}
            phi_extra = audio_synth.a2_pilot_phase(
                self.a2_statics, pp["c1"], pp["s1"], pp["c2"], pp["s2"],
                pp["base_phase"])
            out_i, out_q = audio_synth.fm_add(
                self.fm_right_statics, out_i, out_q,
                *_fm_window(blk.fm_right(), a, nl, whole), phi_extra,
                a2=True)
        if self.am_statics is not None:
            am = {k: lines(v) for k, v in audio["am_mono"].items()}
            out_i, out_q = audio_synth.am_add(
                self.am_statics, out_i, out_q, am["seg_val"], am["seg_col"],
                am["c0"], am["s0"])
        nlines = self.frames_per_block * p.lines
        if self.nicam_statics is not None:
            nc = audio["nicam"]
            signs_i, signs_q = blk.nicam()
            out_i, out_q = audio_synth.nicam_add(
                self.nicam_statics, out_i, out_q, signs_i, signs_q,
                nc["offq"], nc["offr"], lines(nc["cc_off"]),
                audio["nicam_k0mod"], line0=a, block_lines=nlines,
                starts=nc["starts"] if whole else None)
        if self.dance_statics is not None:
            dc = audio["dance"]
            out_i, out_q = audio_synth.nicam_add(
                self.dance_statics, out_i, out_q, dc["signs_i"],
                dc["signs_q"], dc["offq"], dc["offr"], lines(dc["cc_off"]),
                audio["dance_k0mod"], line0=a, block_lines=nlines,
                starts=dc["starts"] if whole else None)

        if self.fm_video_statics is not None:
            tri = None
            if self._fm_ed_frame is not None:
                tri = lines(self._fm_ed_dev.repeat(self.frames_per_block, 1))
            out_i, out_q, carry["fm_r"] = rf_ops.fm_video_modulate(
                self.fm_video_statics, out_i, hand["fm_r"], tri)
        if self.conf.swap_iq:
            out_i, out_q = out_q, out_i
        if self.offset_statics is not None:
            o = {k: lines(v) for k, v in audio["offset"].items()}
            out_i, out_q = rf_ops.offset_rotate(
                self.offset_statics, out_i, out_q, o["c0"], o["s0"],
                o["nz"], o["k"])

        # int16 WRAP, not saturate: every reference mix into the line
        # buffer is a C `int16_t +=` (src/video.c:3261-3450), so an
        # over-range sum wraps.  round() is half to even, as jnp.round.
        wrap = lambda v: ((v + 0x8000) & 0xFFFF) - 0x8000
        ii = wrap(torch.round(out_i).to(torch.int32))
        qq = wrap(torch.round(out_q).to(torch.int32))
        if self.passthru is not None:
            # the reference adds the passthru stream with a plain int16
            # `+=`, which wraps (src/video.c:3517-3541)
            pt = lines(audio["passthru"]).to(torch.int32)
            ii = wrap(ii + pt[..., 0])
            qq = wrap(qq + pt[..., 1])
        return torch.stack([ii, qq], dim=-1).to(torch.int16), carry

    # names of the encoder's device statics, replicated on each further
    # device of a sharded encoder
    _DEVICE_STATICS = ("dstatics", "secam", "fm_statics", "fm_win",
                       "fm_right_statics", "fm_right_win", "a2_statics",
                       "am_statics", "nicam_statics", "nicam_dev_statics",
                       "dance_statics", "offset_statics", "fm_video_statics",
                       "_fm_ed_dev")

    def _step_sharded(self, yuv, m: dict, first: float, audio: dict):
        """The block over the shard plan: the block stage once per
        distinct device, then each shard's row stage on its device, the
        serial carries handed from shard to shard without a wait.
        Returns (shard.ShardedBlock, the carries of the last shard, on
        the encoder's first device)."""
        stages = {}
        for dev in self._plan.distinct():
            rep = shard.replica(self, dev, self._DEVICE_STATICS,
                                services=True)
            audio_d = shard.to_shard(audio, dev)
            stages[shard.device_key(dev)] = (
                rep, rep._block_stage(shard.on(self, dev, "yuv", yuv),
                                      audio_d),
                shard.on(self, dev, "meta", m), audio_d)
        hand = self._hand_in(audio)
        outs = []
        self.shard_events = []
        for win in self._windows:
            rep, blk, m_d, audio_d = stages[shard.device_key(win.device)]
            hand = shard.to_shard(hand, win.device)
            out, hand = shard.timed(self, win, lambda: rep._row_stage(
                blk, m_d, first, audio_d, win, hand))
            outs.append(out)
        # the carries go back to the first device, as an unsharded
        # encoder keeps them, for the host side's catch-up and checkpoint
        return shard.ShardedBlock(outs), shard.to_shard(
            {**blk.carry, **hand}, self.device)

    @staticmethod
    def _stream_fir(x, taps_r, taps_i, W: int, n: int):
        """The stream FIR over a block's flat stream (one halo line
        before its n samples), from half a filter before the block."""
        half = taps_r.shape[0] // 2
        xs = x[W - half: W - half + n + taps_r.shape[0] - 1]
        return stream_fir(xs, taps_r, taps_i, n)

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
        t = lambda a: transfer.upload(np.ascontiguousarray(a), self.device)
        if fw is not None:
            d = self.audio.fm_compact_block(carrier, k0, nlines, fw)
            d["xa"] = t(torch.tensor(d["xa"], dtype=torch.int32))
            for k in ("held", "col0", "ctab", "stab"):
                d[k] = t(d[k])
        else:
            d = self.audio.fm_block(carrier, k0, nlines)
            for k in ("seg_val", "seg_base", "seg_col", "ctab", "stab"):
                d[k] = t(d[k])
        return d

    def _audio_args(self, block_no: int, secam: dict | None = None) -> dict:
        """Host audio-rate computation -> per-block arguments (host ints
        and numpy offsets; the PCM window and tables as tensors).  `secam`
        is the block's `_secam_args` where the caller has built them."""
        nlines = self.frames_per_block * self.params.lines
        k0 = block_no * nlines
        # With the video filter enabled the audio process consumes the
        # filter's one-line-delayed stream, so the audio timeline runs one
        # line ahead of the output line it lands on (src/video.c:4675-4688).
        # The video resampler adds one more line of window lag (its warm-up
        # line is swallowed, so the audio stream starts one line early).
        a_k0 = k0 + (1 if self.conf.vfilter else 0) \
            + (1 if self.resampler is not None else 0)
        dev = self.device
        up = transfer.upload
        args = {}
        if self.services:
            # one claimed mask: a service skips lines an earlier one took
            n = nlines + 1 + self.halo_after
            claimed = np.zeros(n, dtype=bool)
            with telemetry.span("dispatch.audio.services"):
                args["services"] = tuple(
                    transfer.arrays_to_device(
                        svc.block_arrays(k0 - 1, n, claimed), dev)
                    for svc in self.services)
        if self.raw_bb is not None:
            args["rawbb"] = up(self.raw_bb.block(
                k0 - 1, nlines + 1 + self.halo_after), dev)
        if self.passthru is not None:
            args["passthru"] = up(self.passthru.block(
                k0, nlines, self.out_params.width), dev)
        if self.fm_dev_held:
            with telemetry.span("dispatch.audio.fm"):
                args["fm_mono"] = self._held_fm(block_no, a_k0, nlines)
        elif self.fm_statics is not None:
            with telemetry.span("dispatch.audio.fm"):
                args["fm_mono"] = self._host_fm(self.audio.fm_mono, a_k0,
                                                nlines, self.fm_win)
        if self.fm_exact is not None:
            with telemetry.span("dispatch.audio.fm_exact"):
                args["fm_exact"] = up(self._fm_exact_block(a_k0, nlines),
                                      dev)
        if self.fm_right_statics is not None:
            args["fm_right"] = self._host_fm(self.audio.fm_right, a_k0,
                                             nlines, self.fm_right_win)
            args["a2_pilot"] = {
                k: up(v, dev)
                for k, v in self.audio.pilot_block(a_k0, nlines).items()}
        if self.am_statics is not None:
            with telemetry.span("dispatch.audio.am"):
                args["am_mono"] = {
                    k: up(np.ascontiguousarray(v), dev)
                    for k, v in self.audio.am_block(
                        self.audio.am_mono, a_k0, nlines).items()}
        if self.nicam_statics is not None:
            with telemetry.span("dispatch.audio.nicam"):
                nc = self.audio.nicam_device_block(
                    a_k0, nlines, self.nicam_statics, self.nicam_dev_statics,
                    self._nicam_dev_fn)
                nc["starts"] = up(audio_synth.window_starts(
                    self.nicam_statics, nc["offq"], nc["offr"],
                    self.nicam_dev_statics.L, nlines), dev)
                for k in ("pcm", "cc_off"):
                    nc[k] = up(nc[k], dev)
            args["nicam"] = nc
            args["nicam_k0mod"] = a_k0 % self.nicam_statics.period
        if self.dance_statics is not None:
            dc = self.audio.dance_block(a_k0, nlines, self.dance_statics)
            dc["starts"] = up(audio_synth.window_starts(
                self.dance_statics, dc["offq"], dc["offr"],
                len(dc["signs_i"]), nlines), dev)
            for k in ("signs_i", "signs_q", "cc_off"):
                dc[k] = up(dc[k], dev)
            args["dance"] = dc
            args["dance_k0mod"] = a_k0 % self.dance_statics.period
        if self.fm_video_statics is not None:
            if block_no not in self._fm_r:
                raise RuntimeError(
                    "FM-modulated blocks must be encoded sequentially "
                    f"(no phase carry for block {block_no})")
            args["fm_r0"] = self._fm_r[block_no]
        if self.secam is not None:
            args["secam"] = (self._secam_args(block_no) if secam is None
                             else secam)
        if self.offset_statics is not None:
            c0, s0, nz = rf_ops.offset_rotation(
                self.conf.offset, self.params.sample_rate, k0,
                self.out_params.width, nlines)
            k = np.maximum(np.arange(k0, k0 + nlines), 0).astype(np.int32)
            args["offset"] = {name: up(a, dev) for name, a
                              in (("c0", c0), ("s0", s0), ("nz", nz),
                                  ("k", k))}
        return args

    def _held_fm(self, block_no: int, a_k0: int, nlines: int) -> dict:
        """The FM mono carrier's block arguments where its held values
        are computed on the device: the PCM window and tables, and the
        int32 phase anchor chained from the block before."""
        c = self.audio.fm_mono
        if not self._fm_xa_started and block_no not in self._fm_xa:
            # first encoded block may start mid-stream: seed the
            # anchor with the host-exact pre-span sum
            i0b = self.audio.fm_dev_i0(a_k0, self.fm_win)
            self._fm_xa[block_no] = [i0b, transfer.upload(torch.tensor(
                self.audio.fm_dev_seed_xa(c, i0b, self.fm_win),
                dtype=torch.int32), self.device)]
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
            dct[k] = transfer.upload(dct[k], self.device)
        return dct

    def _fm_exact_block(self, a_k0: int, nlines: int) -> np.ndarray:
        """The host-exact sound carrier of an FM-video mode for the
        block's output samples, int16 [nlines, W, 2]; skipped samples
        (before the first block, or a seek forward) advance the carrier
        without output, a seek back restarts it."""
        W = self.out_params.width
        n0, n1 = a_k0 * W, (a_k0 + nlines) * W
        fx = self.fm_exact
        c = self.audio.fm_mono
        if n0 < fx.n:
            fx.reset()
        if fx.n < n0:
            fx.process(self.audio.fm_exact_stream(c, fx.n, n0), fx.n,
                       emit=False)
        out = fx.process(self.audio.fm_exact_stream(c, n0, n1), n0)
        return out.view(np.int16).reshape(nlines, W, 2)

    @telemetry.spanned("dispatch.meta.secam")
    def _secam_args(self, block_no: int) -> dict:
        """The block's SECAM metadata on the device ("meta"), and the IIR
        carry ("z0") of the device program or the host-exact carrier
        add-in ("add").  The per-line metadata is periodic in the stream
        line with period 6 frames (dr parity: 2, carrier phase sign: 3);
        block 0 is special (clamped pre-stream rows).  Building a new key
        is a Python loop over the block's lines (counted in
        secam.meta_builds)."""
        nlines = self.frames_per_block * self.params.lines
        k0 = block_no * nlines
        key = k0 % (6 * self.conf.lines) if k0 > 0 else -1
        hit = self._secam_meta_cache.get(key)
        if hit is not None:
            self._secam_meta_cache.move_to_end(key)
        else:
            telemetry.count("secam.meta_builds")
            nm = secam_mod.block_meta(
                self.params, k0 - 1, nlines + 1 + self.halo_after, nlines,
                self.vframe_y, self.source.height)
            hit = (nm, secam_mod.meta_to_device(nm, self.device))
            while len(self._secam_meta_cache) > 64:
                self._secam_meta_cache.popitem(last=False)
            self._secam_meta_cache[key] = hit
        nm, sm = hit
        if self.secam_device:
            if block_no not in self._secam_z:
                raise RuntimeError(
                    "SECAM blocks must be encoded sequentially "
                    f"(no IIR carry for block {block_no})")
            return {"meta": sm, "host": nm, "z0": self._secam_z[block_no]}
        if block_no not in self._secam_iir:
            raise RuntimeError("SECAM blocks must be encoded sequentially "
                               f"(no IIR state for block {block_no})")
        st = self.secam.st
        W = self.out_params.width
        u, v = self._rgb_host_uv
        chroma, snap, _ = secam_mod.chroma_block_host(
            st, W, nm, u, v, k0 - 1, k0 + nlines - 1,
            self._secam_iir[block_no], cache=self._secam_host_cache)
        self._secam_iir[block_no + 1] = snap
        self._secam_iir.pop(block_no - 2, None)
        add = secam_mod.carrier_addin_host(st, W, nm, chroma,
                                           self._secam_lut)
        return {"meta": sm, "host": nm,
                "add": transfer.upload(add, self.device)}

    def _nicam_dev_fn(self, *a):
        """signs_device on this encoder's statics (the seek catch-up)."""
        return nicam_dev.signs_device(self.nicam_dev_statics, *a)

    def encode_block_device(self, block_no: int):
        """Synthesise one block of frames_per_block frames; returns a
        device tensor: int16 [nlines, W] for real output modes, or int16
        [nlines, W, 2] (I, Q) for complex/audio modes.  A sharded encoder
        returns the shards' tensors in line order (shard.ShardedBlock),
        each on its device.  On a single card the step replays as a CUDA
        graph where its host inputs repeat (`_graphed_step`).  A card's
        tensor carries the event recorded after its step (`_step_done`,
        transfer.mark_done), which its copy back waits on.  With the
        tracer on (telemetry.py) each stage is a span."""
        span = telemetry.span
        with span("dispatch", block_no):
            with span("dispatch.rgb"):
                yuv = self._device_rgb(block_no)
            with span("dispatch.meta"):
                m = self._block_meta(block_no)
                secam = (self._secam_args(block_no)
                         if self.secam is not None else None)
            first = 0.0 if block_no == 0 else 1.0
            step = (self._step_sharded if self._plan is not None
                    else self._step if self._graphs is None
                    else self._graphed_step)
            with span("dispatch.audio"):
                audio = self._audio_args(block_no, secam)
            with span("dispatch.step"):
                out, carry = step(yuv, m, first, audio)
                transfer.mark_done(out)
            with span("dispatch.carry"):
                self._take_carry(block_no, carry)
        return out

    def _take_carry(self, block_no: int, carry: dict) -> None:
        """Keep a step's carries (its device scalars by name) for block
        block_no + 1."""
        if self.fm_dev_held:
            self._fm_xa[block_no + 1][1] = carry["fm_xa"]
        if self.nicam_statics is not None:
            self.audio.nicam_dev_dsym(carry["nicam_dsym"])
        if self.secam_device:
            self._secam_z[block_no + 1] = carry["secam_z"]
            self._secam_z.pop(block_no - 2, None)
        if self.fm_video_statics is not None:
            # a device scalar: the next block chains on it without a sync
            self._fm_r[block_no + 1] = carry["fm_r"]
            self._fm_r.pop(block_no - 2, None)

    # ------------------------------------------------------------------
    # Stream checkpoint/resume: the cross-block carries (FM phases, the
    # SECAM IIR, the audio anchors, the services' schedulers and PRBS
    # state) are explicit state.  The blob holds numpy and plain Python
    # values only, so a checkpoint written on the card resumes on the CPU
    # and the other way round.
    def checkpoint(self, next_block: int) -> bytes:
        """Serialise the stream state so that a FRESH Encoder built with
        the same arguments can `load_checkpoint` and continue at
        `next_block` bit-identically.  Blocks [0, next_block) must have
        been encoded, from an index-addressable (stateless) source."""
        if self.passthru is not None:
            raise NotImplementedError(
                "checkpoint with --passthru is not supported")
        if not getattr(self.source, "stateless", False):
            raise NotImplementedError(
                "checkpoint requires an index-addressable source")
        host = lambda t: t.cpu().numpy()
        b = int(next_block)
        st: dict = {"version": 1, "next_block": b}
        if self.fm_video_statics is not None:
            st["fm_r"] = host(self._fm_r[b])
        if self.fm_dev_held:
            exp, xa = self._fm_xa[b]
            if xa is None:
                raise RuntimeError(f"encode block {b - 1} before "
                                   "checkpointing")
            st["fm_xa"] = (exp, host(xa))
        if self.secam is not None:
            if self.secam_device:
                st["secam_z"] = host(self._secam_z[b])
            else:
                st["secam_iir"] = self._secam_iir[b]
        for nm in ("fm_exact", "fm_video_exact"):
            fx = getattr(self, nm)
            if fx is not None:
                st[nm] = (fx._state.copy(), fx.n)
        st["audio"] = self.audio.state_dict()
        svc = []
        for s in self.services:
            if hasattr(s, "ckpt_state"):
                svc.append(("m", s.ckpt_state()))
            else:
                if getattr(s, "raw", None) is not None:
                    raise NotImplementedError(
                        "checkpoint with a raw: packet stream")
                svc.append(("a", {a: copy.deepcopy(getattr(s, a))
                                  for a in getattr(s, "_CKPT_ATTRS", ())}))
        st["services"] = svc
        return pickle.dumps(st)

    def load_checkpoint(self, blob: bytes) -> int:
        """Restore checkpoint() state into this (freshly built,
        identically configured) encoder; returns the block to encode
        next.  The blob must come from this program: unpickling runs
        code."""
        st = pickle.loads(blob)
        b = st["next_block"]
        dev = lambda a: torch.as_tensor(a, device=self.device)
        if "fm_r" in st:
            self._fm_r = {b: dev(st["fm_r"])}
        if "fm_xa" in st:
            exp, xa = st["fm_xa"]
            self._fm_xa = {b: [exp, dev(xa)]}
            self._fm_xa_started = True
        if "secam_z" in st:
            self._secam_z = {b: dev(st["secam_z"])}
        if "secam_iir" in st:
            self._secam_iir = {b: st["secam_iir"]}
        for nm in ("fm_exact", "fm_video_exact"):
            if nm in st:
                fx = getattr(self, nm)
                state, n = st[nm]
                fx._state[:] = state
                fx.n = n
        self.audio.load_state(st["audio"], self.device)
        for s, (kind, data) in zip(self.services, st["services"]):
            if kind == "m":
                s.ckpt_load(data)
            else:
                for a, v in data.items():
                    setattr(s, a, v)
        return b

    @property
    def frame_samples(self) -> int:
        """Output samples per frame."""
        return self.out_params.frame_samples

    encode_block = transfer.encode_block

    def collect_block(self, block_no: int, dev: torch.Tensor) -> np.ndarray:
        """Device tensor -> host int16 samples (transfer.collect_block);
        the copy of block b overlaps block b+1's step.  For FM video on
        the host the FM recurrence runs here over the composite (the I
        channel), so blocks must be collected in order."""
        return transfer.collect_block(
            self, block_no, dev,
            None if self.fm_video_exact is None else self._fm_video_host)

    def _fm_video_host(self, block_no: int, a: np.ndarray) -> np.ndarray:
        """The host-exact FM-video recurrence over a block's composite
        (the I channel of `a`): interleaved int16 I/Q pairs."""
        comp = np.ascontiguousarray(a[..., 0]).reshape(-1)
        if self._fm_ed_frame is not None:
            # the frame-locked triangle, added with int16 wrap
            # (src/video.c:2303) before the FM recurrence
            t = np.tile(self._fm_ed_frame.reshape(-1),
                        self.frames_per_block)
            comp = (((comp.astype(np.int32) + t + 0x8000) & 0xFFFF)
                    - 0x8000).astype(np.int16)
        fx = self.fm_video_exact
        n0 = block_no * comp.size
        if n0 < fx.n:
            fx.reset()
        if fx.n < n0:
            raise RuntimeError("FM blocks must be collected "
                               "sequentially")
        return fx.process(comp, n0).view(np.int16).reshape(-1, 2)

    def block_audio_pcm(self, block_no: int):
        """32 kHz int16 stereo pairs consumed during this block
        (volume-scaled, after the Syster inversion): the sink audio
        side-channel the reference feeds from its audio process
        (src/video.c:3306-3310), which the HackDAC and FL2K sinks
        consume.  None for modes without audio."""
        if not self.has_audio:
            return None
        a = self.audio
        n = self.frames_per_block * self.conf.lines * self.out_params.width
        p0 = block_no * n * a.A // a.S
        p1 = (block_no + 1) * n * a.A // a.S
        return a._pcm(p0, p1 - p0).astype(np.int16)

    def encode_frame(self, frame_no: int) -> np.ndarray:
        """Single-frame convenience API (frames_per_block must be 1)."""
        assert self.frames_per_block == 1
        return self.encode_block(frame_no)

    # the JAX package's older names
    _encode_frame_dev = encode_block_device
    encode_frame_device = encode_block_device

    def iter_frames(self, n_frames: int):
        """Frames 0..n_frames-1 as host samples, one a block
        (frames_per_block must be 1)."""
        assert self.frames_per_block == 1
        for f in range(n_frames):
            yield self.encode_frame(f)


class _BlockStage:
    """The block's replicated [nlines]-vector work on one device: the FM
    carriers' segment assembly (held values, the exact phase prefix sums)
    and NICAM's bit pipeline.  Each part runs where the row stage first
    reads it, once for all the device's shards: on one device the card
    then runs it between the row chain's kernels, where the host's
    enqueue of it overlaps the card's work, as in an unsharded step.
    `carry` collects the block's carries ("fm_xa", "nicam_dsym")."""

    def __init__(self, enc: Encoder, yuv, audio: dict):
        self.enc, self.yuv, self.audio = enc, yuv, audio
        self.carry: dict = {}
        self._parts: dict = {}

    def _once(self, name: str, fn):
        if name not in self._parts:
            self._parts[name] = fn()
        return self._parts[name]

    def fm(self) -> tuple:
        """fm_add's segment arguments of the FM mono carrier."""
        def part():
            e = self.enc
            d = self.audio["fm_mono"]
            if not e.fm_dev_held:
                return e._fm_args(d, e.fm_win, e.fm_statics)
            held = audio_synth.held_device(e.audio.fm_mono, d["pcm"],
                                           _LIM_HIST)
            args, self.carry["fm_xa"] = audio_synth.fm_prepare(
                e.fm_win, e.fm_statics, e.frames_per_block * e.params.lines,
                held, d["xa"], d["lens_off"], d["offq"], d["offr"],
                d["col0"], d["ctab"], d["stab"], adv=d["adv"])
            return args
        return self._once("fm", part)

    def fm_right(self) -> tuple:
        """fm_add's segment arguments of the A2 second carrier."""
        e = self.enc
        return self._once("fm_right", lambda: e._fm_args(
            self.audio["fm_right"], e.fm_right_win, e.fm_right_statics))

    def nicam(self) -> tuple:
        """NICAM's (signs_i, signs_q) for the block."""
        def part():
            nc = self.audio["nicam"]
            si, sq, self.carry["nicam_dsym"] = nicam_dev.signs_device(
                self.enc.nicam_dev_statics, nc["pcm"], nc["dsym_in"],
                nc["famod16"], nc["base_off"], nc["nkeep"])
            return si, sq
        return self._once("nicam", part)


def _fm_window(args: tuple, a: int, n: int, whole: bool) -> tuple:
    """fm_add's segment arguments (seg_val, seg_cnt, seg_col, ctab, stab,
    unit) of a whole block, for its lines [a, a + n)."""
    if whole:
        return args
    seg_val, seg_cnt, seg_col, ctab, stab, unit = args
    return (seg_val[a:a + n], seg_cnt[a:a + n], seg_col[a:a + n],
            shard.period_window(ctab, a, n), shard.period_window(stab, a, n),
            unit)


class _OrientedSource:
    """The mode's frame orientation (a quarter-turn rotation and flips),
    applied when a frame is read, as the reference does
    (src/video.c:4881-4885)."""

    def __init__(self, inner, orientation: int):
        self.inner = inner
        self.stateless = getattr(inner, "stateless", False)
        self.orientation = orientation
        w, h = inner.width, inner.height
        if (orientation & 3) in (1, 3):
            w, h = h, w
        self.width, self.height = w, h
        self.interlaced = getattr(inner, "interlaced", 0)
        self._cache: tuple | None = None

    def read_video(self, frame_no: int) -> np.ndarray:
        rgb = self.inner.read_video(frame_no)
        if self._cache is not None and self._cache[0] is rgb:
            return self._cache[1]
        out = frame_ops.rotate(rgb, self.orientation & 3)
        if self.orientation & 4:
            out = frame_ops.hflip(out)
        if self.orientation & 8:
            out = frame_ops.vflip(out)
        out = np.ascontiguousarray(out)
        self._cache = (rgb, out)
        return out

    def read_audio(self, start: int, count: int) -> np.ndarray:
        return self.inner.read_audio(start, count)

    def read_cc608(self, frame_no: int):
        f = getattr(self.inner, "read_cc608", None)
        return f(frame_no) if f is not None else (0, 0)

    def eof(self, frame_no: int) -> bool:
        f = getattr(self.inner, "eof", None)
        return bool(f(frame_no)) if f is not None else False

    def close(self) -> None:
        if hasattr(self.inner, "close"):
            self.inner.close()


class _RawBBReader:
    """Looping int16 raw-baseband line source (src/video.c:2406-2445).

    Absolute sample n of the stream maps to file sample n mod T: the
    reference freads and rewinds at EOF with no line alignment, so the
    file cycles at sample granularity.  The samples are rescaled to the
    mode's blanking..white range with C integer division."""

    def __init__(self, path: str, width: int, rbb_blanking: int,
                 rbb_white: int, blanking_level: int, white_level: int):
        self.data = np.fromfile(path, dtype=np.int16)
        if len(self.data) == 0:
            raise ValueError(f"{path}: empty raw baseband file")
        self.W = width
        self.num = white_level - blanking_level
        self.den = rbb_white - rbb_blanking
        self.rbb_blanking = rbb_blanking
        self.blanking_level = blanking_level

    def block(self, k0: int, nlines: int) -> np.ndarray:
        """f32 [nlines, W] for stream lines [k0, k0 + nlines)."""
        n0 = max(k0, 0) * self.W
        idx = (n0 + np.arange(nlines * self.W, dtype=np.int64)) \
            % len(self.data)
        raw = self.data[idx].astype(np.int64)
        # C integer division truncates toward zero
        num = (raw - self.rbb_blanking) * self.num
        q = np.sign(num) * (np.abs(num) // abs(self.den)) * np.sign(self.den)
        out = self.blanking_level + q
        # int16 assignment wraps
        out = ((out + 0x8000) & 0xFFFF) - 0x8000
        block = out.reshape(nlines, self.W).astype(np.float32)
        if k0 < 0:
            block[:-k0] = block[0]   # halo before the stream start: line 0
        return block


class _PassthruReader:
    """Sequential int16 I/Q add-stream (src/video.c:3517-3541): zeros
    after EOF (the reference stops adding)."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        self.eof = False

    def block(self, k0: int, nlines: int, width: int) -> np.ndarray:
        """int16 [nlines, width, 2]: the next nlines * width pairs."""
        n = nlines * width
        out = np.zeros((n, 2), dtype=np.int16)
        if not self.eof:
            raw = np.frombuffer(self.f.read(n * 4), dtype=np.int16)
            if len(raw) < n * 2:
                self.eof = True
                # a partial final line is dropped, like the reference's
                # short fread (src/video.c:3529-3532)
                raw = raw[: (len(raw) // (width * 2)) * width * 2]
            out[: len(raw) // 2] = raw.reshape(-1, 2)
        return out.reshape(nlines, width, 2)
