"""Command-line interface: the subset of hacktv's options that the port
covers (port of hacktv_tpu/cli.py).

    python -m hacktv_tpu_torch -m i --frames 4 -o out.bin test
    python -m hacktv_tpu_torch -m i --filter -o out.bin raw:clip.raw:720x576

write 4 frames of PAL-I with FM and NICAM-728 sound, and PAL-I through
the VSB filter from a raw RGB32 file until it ends, as interleaved int16
I/Q.  Inputs, played in order: `test` (the test card), `raw:PATH[:WxH]`
(RGB32 frames, with PATH.pcm sound and PATH.cc608 captions),
`ffmpeg:PATH` or a bare path (the ffmpeg binary when it is on PATH,
OpenCV otherwise), fitted to the active picture (--fit, --letterbox,
--pillarbox, --min-aspect, --max-aspect) and sequenced with -r/--repeat
and --shuffle; --ffmt and --fopts pass an input format and its options
to ffmpeg.  Accepted besides: -v/--verbose (the mode report and a
progress line and the sink's counts at close), --version, --threads
(ignored), --profile DIR (the tracer on, telemetry.py: a torch.profiler
trace of the encode loop with the program's spans in it, and the spans'
totals and counters), -m MODE, --list-modes
[--json], -s RATE, --pixelrate
RATE, -l LEVEL, -D DEVIATION, -G GAMMA, --fm-energy-dispersal, -i,
--volume, --nocolour/--nocolor, --s-video, --invert-video, --filter,
--noaudio, --nonicam, --a2stereo, --swap-iq, --offset HZ, --passthru FILE,
--raw-bb-file FILE, --raw-bb-blanking N, --raw-bb-white N,
--secam-field-id, --secam-field-id-lines N, --secam-exact, the VBI
services --teletext PATH, --wss MODE, --vits, --vitc, --cc608, --acp and
--sis MODE, the scramblers --videocrypt MODE, --videocrypt2 MODE,
--videocrypts MODE, --syster MODE, --systercnr MODE, --d11 MODE,
--key-table-1, --key-table-2 and --systeraudio, the D/D2-MAC switches
--single-cut, --double-cut, --eurocrypt MODE, --ec-mat-rating N, --ec-ppv
[PPV], --nodate, --showecm, --scramble-audio, --chid ID and
--mac-audio-{stereo,mono,high-quality,medium-quality,companded,linear,
l1-protection,l2-protection}, -t TYPE, -o OUTPUT, the hardware sinks'
-f/--frequency HZ, -g/--gain DB, -A/--amp, --antenna NAME and
--fl2k-audio {none,stereo,spdif}, --frames N, --seconds S,
--frames-per-block N, --device {cuda,cpu}, --devices N (each block's
lines sharded over the first N cards, or N CPU shards with --device cpu;
the same bytes as one device) and --hosts N with --host I (or
$HACKTV_HOST_ID): process I of N encodes its contiguous range of the
--frames/--seconds stream's blocks into OUTPUT.partI, and process 0
joins the parts into OUTPUT once every part is done.  The MAC modes run
video/mac.py's MacEncoder.  The run stops at --frames/--seconds, or when
the inputs end.
HACKTV_TPU_TELETEXT_TIME=<unix seconds> fixes the teletext clock, as for
hacktv_tpu, so that a run is deterministic.  `-o hackrf[:SERIAL]`,
`soapysdr[:ARGS]` and `fl2k[:INDEX]` feed a transmitter through
rf/hardware.py (HackDAC or FL2K baseband where the mode's output is
real, the sound to the sink's audio side-channel); without the vendor
library the run exits non-zero naming it.  Any other output goes through
the native runtime's threaded file sink (runtime.NativeFileSink), built
at first use; without a C++ compiler it raises.  Any other switch is
refused.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import time
from dataclasses import replace

import numpy as np

from . import telemetry
from .config.standards import REGISTRY, ColourMode, get_mode, list_modes


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hacktv_tpu_torch",
        description="analogue TV signal generator on an NVIDIA GPU "
                    "(hacktv-compatible subset)")
    a = p.add_argument
    a("input", nargs="*", default=["test"],
      help="input: 'test' (test card), 'raw:<file>' (RGB32+PCM), "
           "'ffmpeg:<path>' or a path (ffmpeg binary, else OpenCV)")
    a("-o", "--output", default="-",
      help="output: hackrf[:serial], soapysdr[:args], fl2k[:index], "
           "file:<path>, a bare path, or - for stdout")
    a("-m", "--mode", default="i", help="TV mode id (see --list-modes)")
    a("--list-modes", action="store_true")
    a("--json", action="store_true")
    a("--fit", choices=["stretch", "fill", "fit", "none"], default=None)
    a("--min-aspect", default=None)
    a("--max-aspect", default=None)
    a("--letterbox", action="store_true")
    a("--pillarbox", action="store_true")
    a("-r", "--repeat", action="store_true")
    a("--shuffle", action="store_true")
    a("-v", "--verbose", action="store_true")
    a("--profile", default=None, metavar="DIR",
      help="write a torch.profiler trace of the encode loop, with the "
           "program's spans, and the spans' totals and counters into DIR")
    a("--ffmt", default=None, help="ffmpeg input format hint")
    a("--fopts", default=None, help="ffmpeg input format options")
    a("--threads", action="store_true", help="accepted for compatibility")
    a("--version", action="store_true")
    a("-s", "--samplerate", type=float, default=16e6)
    a("--pixelrate", type=float, default=0)
    a("-l", "--level", type=float, default=None)
    a("-D", "--deviation", type=float, default=None)
    a("-G", "--gamma", type=float, default=None)
    a("--fm-energy-dispersal", type=float, default=None)
    a("-i", "--interlace", action="store_true")
    a("--volume", type=float, default=None)
    a("--nocolour", "--nocolor", action="store_true", dest="nocolour")
    a("--s-video", action="store_true", dest="s_video")
    a("--invert-video", action="store_true")
    a("--filter", action="store_true", dest="vfilter")
    a("--noaudio", action="store_true")
    a("--nonicam", action="store_true")
    a("--a2stereo", action="store_true",
      help="A2 (Zweikanalton) stereo: a second FM sound carrier")
    a("--swap-iq", action="store_true")
    a("--offset", type=float, default=0)
    a("--passthru", default=None, metavar="FILE")
    a("--raw-bb-file", default=None, metavar="FILE")
    a("--raw-bb-blanking", type=int, default=0)
    a("--raw-bb-white", type=int, default=0x300)
    a("--secam-field-id", action="store_true")
    a("--secam-field-id-lines", type=int, default=None)
    a("--secam-exact", action="store_true",
      help="the host-exact SECAM chroma (the default of secam-fm)")
    a("--teletext", default=None, metavar="PATH",
      help="teletext from a .tti file, a directory of them, or raw:FILE "
           "of 42-byte packets")
    a("--wss", default=None, metavar="MODE",
      help="widescreen signalling on line 23 (4:3, 16:9, auto, ...)")
    a("--vits", action="store_true", help="insertion test signals")
    a("--vitc", action="store_true", help="vertical interval timecode")
    a("--cc608", action="store_true", help="CEA-608 closed captions")
    a("--acp", action="store_true", help="analogue copy protection")
    a("--sis", default=None, metavar="MODE",
      help="sound-in-syncs (dcsis)")
    a("--videocrypt", default=None, metavar="MODE",
      help="Videocrypt I (free, conditional)")
    a("--videocrypt2", default=None, metavar="MODE",
      help="Videocrypt II (free)")
    a("--videocrypts", default=None, metavar="MODE",
      help="Videocrypt S (free, conditional)")
    a("--syster", default=None, metavar="MODE",
      help="Nagravision Syster line shuffle (premiere-fa, ...)")
    a("--key-table-1", action="store_true",
      help="Syster: the standard key table")
    a("--key-table-2", action="store_true",
      help="Syster: the Canal+ France (Oct 1997) key table")
    a("--d11", default=None, metavar="MODE", help="Discret 11")
    a("--systercnr", default=None, metavar="MODE",
      help="Syster cut-and-rotate, alone or with --syster")
    a("--systeraudio", action="store_true",
      help="Syster audio spectrum inversion")
    a("--single-cut", action="store_true",
      help="MAC: single-cut line rotation")
    a("--double-cut", action="store_true",
      help="MAC: double-cut line rotation")
    a("--eurocrypt", default=None, metavar="MODE",
      help="MAC: Eurocrypt conditional access (filmnet, tv2, ctv, ...)")
    a("--ec-mat-rating", type=int, default=0,
      help="Eurocrypt maturity rating")
    a("--ec-ppv", default=None, nargs="?", const="0,0",
      help="Eurocrypt pay-per-view: programme number and cost")
    a("--nodate", action="store_true",
      help="Eurocrypt: leave the date out of the ECMs")
    a("--showecm", action="store_true",
      help="print Eurocrypt ECM/EMM details to stderr")
    a("--scramble-audio", action="store_true",
      help="MAC: scramble the audio packets")
    a("--chid", type=lambda x: int(x, 0), default=None,
      help="MAC: the channel ID")
    a("--mac-audio-stereo", action="store_true")
    a("--mac-audio-mono", action="store_true")
    a("--mac-audio-high-quality", action="store_true")
    a("--mac-audio-medium-quality", action="store_true")
    a("--mac-audio-companded", action="store_true")
    a("--mac-audio-linear", action="store_true")
    a("--mac-audio-l1-protection", action="store_true")
    a("--mac-audio-l2-protection", action="store_true")
    a("-t", "--type", default="int16",
      choices=["uint8", "int8", "uint16", "int16", "int32", "float"])
    a("-f", "--frequency", type=float, default=0,
      help="RF frequency in Hz (hardware sinks)")
    a("-g", "--gain", type=int, default=0, help="TX gain (hardware sinks)")
    a("-A", "--amp", action="store_true", help="enable TX amp (hackrf)")
    a("--antenna", default=None, help="antenna name (soapysdr)")
    a("--fl2k-audio", default="none", choices=["none", "stereo", "spdif"],
      help="FL2K audio on the G/B channels: none, stereo or S/PDIF")
    a("--frames", type=int, default=0,
      help="stop after N frames (0 = until interrupted)")
    a("--seconds", type=float, default=0,
      help="stop after S seconds of signal")
    a("--frames-per-block", type=int, default=0,
      help="frames synthesised per device call (0 = 16 for the test "
           "card, 8 for moving inputs, 1 for moving SECAM, field-"
           "sequential or MAC; at most --frames)")
    a("--device", default="cuda", choices=["cuda", "cpu"],
      help="where the encoder runs (default: the CUDA card)")
    a("--devices", type=int, default=0, metavar="N",
      help="shard each block's line axis over the first N cards (N CPU "
           "shards with --device cpu; 0 = single device); output is "
           "bit-identical to single-device")
    a("--hosts", type=int, default=0, metavar="N",
      help="multi-host streaming: split the --frames stream into N "
           "contiguous block ranges, one per process; each process "
           "writes <out>.partI and host 0 concatenates the ordered parts "
           "when all are complete")
    a("--host", type=int, default=0, metavar="I",
      help="this process's 0-based index for --hosts (defaults to "
           "$HACKTV_HOST_ID or 0)")
    return p


def _print_modes(as_json: bool) -> None:
    if as_json:
        out = {"modes": [{"id": k, "description": d}
                         for k, d in list_modes()]}
        print(json.dumps(out, indent=2))
    else:
        for k, d in list_modes():
            print(f"  {k:<14} = {d}")


def _apply_overrides(conf, args):
    """The switches that change the mode's configuration."""
    kw = {}
    if args.level is not None:
        kw["level"] = args.level
    if args.deviation is not None:
        kw["fm_deviation"] = args.deviation
    if args.fm_energy_dispersal is not None:
        kw["fm_energy_dispersal"] = args.fm_energy_dispersal
    if args.gamma is not None:
        kw["gamma"] = args.gamma
    if args.interlace:
        kw["interlace"] = 1
    if args.volume is not None:
        kw["volume"] = args.volume
    if args.nocolour:
        kw["colour_mode"] = ColourMode.MONOCHROME
    if args.s_video:
        kw["s_video"] = True
    if args.noaudio:
        kw.update(fm_mono_level=0.0, fm_left_level=0.0, fm_right_level=0.0,
                  am_audio_level=0.0, nicam_level=0.0, dance_level=0.0)
    if args.nonicam:
        kw["nicam_level"] = 0.0
    if args.invert_video:
        kw["invert_video"] = True
    if args.secam_field_id:
        kw["secam_field_id"] = True
    if args.secam_field_id_lines is not None:
        kw["secam_field_id_lines"] = args.secam_field_id_lines
    if args.chid is not None:
        kw["chid"] = args.chid
    if args.mac_audio_mono:
        kw["mac_audio_stereo"] = False
    if args.mac_audio_stereo:
        kw["mac_audio_stereo"] = True
    if args.mac_audio_medium_quality:
        kw["mac_audio_quality"] = False
    if args.mac_audio_high_quality:
        kw["mac_audio_quality"] = True
    if args.mac_audio_linear:
        kw["mac_audio_companded"] = False
    if args.mac_audio_companded:
        kw["mac_audio_companded"] = True
    if args.mac_audio_l2_protection:
        kw["mac_audio_protection"] = True
    if args.mac_audio_l1_protection:
        kw["mac_audio_protection"] = False
    return replace(conf, **kw) if kw else conf


def _check_services(args, conf) -> None:
    """The reference's service/mode cross-checks (src/hacktv.c:1184-1437),
    with hacktv_tpu's messages, in its order."""
    if (args.videocrypt or args.videocrypt2) and \
            conf.colour_mode not in (ColourMode.PAL, ColourMode.MONOCHROME):
        raise SystemExit("videocrypt requires a PAL mode")
    if args.single_cut or args.double_cut:
        if conf.mac_mode is None:
            raise SystemExit("single/double cut requires a MAC mode")
    if args.eurocrypt and conf.mac_mode is None:
        raise SystemExit("eurocrypt requires a MAC mode")
    if args.a2stereo and conf.mac_mode is not None:
        raise SystemExit("a2stereo is not available for MAC modes")
    scramblers = [s for s in (args.videocrypt, args.videocrypt2,
                              args.videocrypts, args.syster, args.d11)
                  if s]
    if args.videocrypt and args.videocrypt2 and not (
            args.videocrypt == "free" and args.videocrypt2 == "free"):
        raise SystemExit("Videocrypt I and II cannot be used together "
                         "except in free-access mode")
    if len(scramblers) > 1 and not (
            len(scramblers) == 2 and args.videocrypt and args.videocrypt2):
        raise SystemExit("Using multiple scrambling modes is not "
                         "supported")
    # any 625-line mode or any PAL mode (SECAM-L with Syster is the real
    # French configuration; src/hacktv.c:1207, 1218, 1236, 1306), and
    # Discret 11 with SECAM too (src/hacktv.c:1289)
    ok625_pal = conf.lines == 625 or conf.colour_mode == ColourMode.PAL
    for flag, name in ((args.videocrypt, "Videocrypt I"),
                       (args.videocrypt2, "Videocrypt II"),
                       (args.videocrypts, "Videocrypt S"),
                       (args.syster, "Nagravision Syster")):
        if flag and not ok625_pal:
            raise SystemExit(f"{name} is only compatible with 625 line "
                             "PAL modes")
    if args.d11 and not (conf.lines == 625
                         or conf.colour_mode == ColourMode.SECAM):
        raise SystemExit("Discret 11 is only compatible with 625 line "
                         "PAL modes")
    if args.acp:
        if conf.lines not in (525, 625):
            raise SystemExit("Analogue Copy Protection is only compatible "
                             "with 525 and 625 line modes")
        if scramblers:
            raise SystemExit("Analogue Copy Protection cannot be used with "
                             "video scrambling enabled")
    if args.teletext and conf.lines != 625:
        raise SystemExit("Teletext is only available with 625 line modes")
    if args.wss and conf.lines != 625:
        raise SystemExit("WSS is only supported for 625 line modes")
    if (args.vits or args.vitc or args.cc608) \
            and conf.lines not in (525, 625):
        raise SystemExit("VITS/VITC/CEA-608 are only supported for 625 "
                         "and 525 line raster modes")
    if args.sis and conf.lines != 625:
        raise SystemExit("SiS is only available with 625 line modes")
    if (args.ec_mat_rating or args.ec_ppv) and not args.eurocrypt:
        raise SystemExit("Maturity rating / PPV options are only used "
                         "in conjunction with Eurocrypt")


def _make_source(spec: str, active_width: int, active_lines: int,
                 frame_rate, ffmt=None, fopts=None):
    """One input of the list: the test card, a raw RGB32 file, or a video
    file through ffmpeg (or OpenCV without the binary)."""
    from .av.testcard import TestCardSource
    if spec == "test":
        return TestCardSource(active_width, active_lines)
    if spec.startswith("raw:"):
        from .av.rawfile import RawFileSource
        return RawFileSource(spec[4:], active_width, active_lines)
    from .av.ffmpeg import open_video_source
    path = spec.split(":", 1)[1] if spec.startswith("ffmpeg:") else spec
    return open_video_source(path, active_width, active_lines,
                             frame_rate=frame_rate, ffmt=ffmt, fopts=fopts)


def _build_source(args, conf, active_width):
    """Input list -> one AV source: the fit geometry applied to each
    input but the test card, several inputs (or --repeat/--shuffle)
    sequenced (src/hacktv.c:1502-1598)."""
    from .av.frame_ops import FitConfig, FitSource
    from .av.sequence import SequenceSource
    from .rational import Rational

    aw, al = active_width, conf.active_lines
    need_fit = (args.fit is not None or args.letterbox or args.pillarbox
                or args.min_aspect or args.max_aspect
                or any(s != "test" for s in args.input))
    ratios = (Rational(4, 3),)
    if args.letterbox or args.pillarbox:
        ratios = (Rational(16, 9),) if args.letterbox else (Rational(4, 3),)
    elif conf.mac_mode is not None:
        ratios = (Rational(4, 3), Rational(16, 9))

    def parse_ratio(s):
        if s is None:
            return None
        if ":" in s:
            a, b = s.split(":")
            return Rational(int(a), int(b))
        return Rational(*float(s).as_integer_ratio())

    cfg = FitConfig(
        width=aw, height=al,
        fit_mode=args.fit or ("fit" if args.letterbox or args.pillarbox
                              else "stretch"),
        display_aspect_ratios=ratios,
        min_display_aspect_ratio=parse_ratio(args.min_aspect),
        max_display_aspect_ratio=parse_ratio(args.max_aspect))

    def make(spec):
        def f():
            src = _make_source(spec, aw, al, conf.frame_rate,
                               ffmt=args.ffmt, fopts=args.fopts)
            if need_fit and spec != "test":
                # the stream's PAR (anamorphic DVD/DVB input) feeds the
                # DAR maths (src/av_ffmpeg.c:606-680)
                spar = getattr(src, "pixel_aspect_ratio", None)
                par = (Rational(spar.numerator, spar.denominator)
                       if spar is not None else None)
                return FitSource(src, cfg, par=par)
            return src
        return f

    if len(args.input) == 1 and not args.repeat and not args.shuffle:
        return make(args.input[0])()
    return SequenceSource([make(s) for s in args.input],
                          repeat=args.repeat, shuffle=args.shuffle)


def _open_sink(args, complex_out: bool):
    """The output: a hardware sink for hackrf, soapysdr or fl2k (with an
    optional :serial), else the native threaded file sink on file:PATH,
    a bare path or - (stdout)."""
    target = args.output
    for hw in ("hackrf", "soapysdr", "fl2k"):
        if target == hw or target.startswith(hw + ":"):
            return _open_hw_sink(args, hw, complex_out)
    if target.startswith("file:"):
        target = target[5:]
    from .runtime import NativeFileSink
    return NativeFileSink(target, args.type, complex_out)


def _open_hw_sink(args, hw: str, complex_out: bool):
    """A hardware sink through its vendor library; without the library,
    or with no device answering, the run exits naming it."""
    from .rf import hardware
    target = args.output
    serial = target.split(":", 1)[1] if ":" in target else None
    try:
        return hardware.open_sink(
            hw, serial, sample_rate=int(args.samplerate),
            frequency=int(args.frequency), gain=int(args.gain),
            amp=args.amp, antenna=args.antenna,
            complex_out=complex_out,
            # HackDAC/FL2K baseband mode when the output is real
            # (src/hacktv.c:1452, :1480)
            baseband=not complex_out,
            fl2k_audio=args.fl2k_audio)
    except hardware.HardwareUnavailable as e:
        raise SystemExit(str(e))


def _frames_per_block(args, conf, frames: int) -> int:
    """--frames-per-block, or 16 for the test card and 8 for moving
    inputs, whose frames stack on the device; 1 for moving SECAM,
    field-sequential colour and MAC, which take one frame a block; never
    more than a bounded capture."""
    fpb = args.frames_per_block
    if fpb <= 0:
        if args.input == ["test"]:
            fpb = 16
        elif conf.mac_mode is None and conf.colour_mode not in (
                ColourMode.SECAM, ColourMode.APOLLO_FSC,
                ColourMode.CBS_FSC):
            fpb = 8
        else:
            fpb = 1
        if frames:
            fpb = min(fpb, frames)
    return fpb


def _report(args, conf, enc, sample_rate, pixel_rate) -> None:
    """The vid_info()-style mode report (src/video.c:4846-4860)."""
    fr = conf.frame_rate
    width = enc.frame_samples // conf.lines
    if conf.mac_mode is not None:
        aw, al = type(enc).active_geometry(conf, sample_rate, pixel_rate)
    else:
        aw, al = enc.params.active_width, conf.active_lines
    print(f"Mode: {args.mode} ({REGISTRY[args.mode][1]})", file=sys.stderr)
    print(f"Video: {aw}x{al} {fr.num / fr.den:.2f} fps "
          f"(full frame {width}x{conf.lines})", file=sys.stderr)
    if pixel_rate and int(pixel_rate) != int(sample_rate):
        print(f"Pixel rate: {int(pixel_rate)}", file=sys.stderr)
    print(f"Sample rate: {int(sample_rate)} "
          f"({'complex' if enc.complex_out else 'real'} int16)",
          file=sys.stderr)


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.version:
        print("hacktv_tpu_torch 0.1.0 (hacktv on an NVIDIA GPU)")
        return 0
    if args.list_modes:
        _print_modes(args.json)
        return 0
    try:
        conf = get_mode(args.mode)
    except KeyError as e:
        raise SystemExit(str(e))
    conf = _apply_overrides(conf, args)
    sample_rate = int(args.samplerate)
    pixel_rate = int(args.pixelrate)

    # pixel-rate suitability warning (src/video.c:2385-2404): a whole
    # number of samples per line needs a multiple of
    # lines * frame_rate / gcd
    pr = pixel_rate or sample_rate
    m = conf.lines * conf.frame_rate.num
    m //= math.gcd(m, conf.frame_rate.den)
    if pr % m:
        r = pr // m
        print(f"Warning: Pixel rate {pr} may not work well with this "
              "mode.", file=sys.stderr)
        print(f"Next valid pixel rates: {m * r}, {m * (r + 1)}",
              file=sys.stderr)
    _check_services(args, conf)

    frames = args.frames
    if args.seconds:
        fr = conf.frame_rate
        frames = max(frames, int(np.ceil(args.seconds * fr.num / fr.den)))
    fpb = _frames_per_block(args, conf, frames)

    devices = None
    if args.devices:
        if args.device == "cpu":
            devices = ["cpu"] * args.devices
        else:
            import torch
            avail = torch.cuda.device_count()
            if args.devices > avail:
                raise SystemExit(f"--devices {args.devices}: only "
                                 f"{avail} cuda devices available")
            devices = [f"cuda:{k}" for k in range(args.devices)]

    if args.profile:
        # the tracer on from here: the encoder's set-up is a span
        telemetry.enable(True)
    if conf.mac_mode is not None:
        from .video.mac import MacEncoder
        aw, _ = MacEncoder.active_geometry(conf, sample_rate, pixel_rate)
        source = _build_source(args, conf, aw)
        enc = _mac_encoder(args, conf, sample_rate, pixel_rate, fpb, source,
                           devices)
    else:
        from .video.params import VideoParams
        p = VideoParams.create(conf, sample_rate, pixel_rate)
        source = _build_source(args, conf, p.active_width)
        enc = _encoder(args, conf, sample_rate, pixel_rate, fpb, source,
                       devices)

    # multi-host streaming: this process encodes a contiguous block range
    # into <out>.part<I>; host 0 joins the ordered parts into <out> once
    # every part is complete
    host_split = None
    if args.hosts and args.hosts > 1:
        hid = args.host or int(os.environ.get("HACKTV_HOST_ID", "0"))
        if not frames:
            raise SystemExit("--hosts requires a finite stream "
                             "(--frames or --seconds)")
        if not (0 <= hid < args.hosts):
            raise SystemExit(f"--host {hid} out of range for "
                             f"--hosts {args.hosts}")
        out = args.output
        if out == "-" or any(out == h or out.startswith(h + ":")
                             for h in ("hackrf", "soapysdr", "fl2k")):
            raise SystemExit("--hosts requires a file output")
        if conf.mac_mode is not None:
            raise SystemExit("--hosts: the MAC packet multiplex is a "
                             "sequential stream; shard MAC blocks "
                             "with --devices instead")
        base_out = out[5:] if out.startswith("file:") else out
        total_blocks = -(-frames // fpb)
        bounds = [total_blocks * j // args.hosts
                  for j in range(args.hosts + 1)]
        host_split = (args.hosts, hid, base_out, bounds)
        args.output = f"{base_out}.part{hid}"

    sink = _open_sink(args, enc.complex_out)
    if args.verbose:
        _report(args, conf, enc, sample_rate, pixel_rate)

    t0 = time.monotonic()
    samples_out = 0
    frames_done = 0
    block = 0
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if enc.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        # one-block pipeline: block b+1 is queued on the device before
        # block b is copied back and written; the inputs' end stops the
        # dispatch
        dispatched = 0
        blk_hi = None
        if host_split is not None:
            _, hid, _, bounds = host_split
            block, blk_hi = bounds[hid], bounds[hid + 1]
            dispatched = frames_done = block * fpb
        pending = None
        while True:
            nxt = None
            if not (frames and dispatched >= frames) \
                    and not (blk_hi is not None and block >= blk_hi) \
                    and not source.eof(dispatched):
                nxt = (block, enc.encode_block_device(block))
                block += 1
                dispatched += fpb
            if pending is not None:
                b0, dev = pending
                out = enc.collect_block(b0, dev)
                if out.ndim == 1:
                    out = np.stack([out, np.zeros_like(out)], axis=-1)
                if frames and frames_done + fpb > frames:
                    out = out[: (frames - frames_done) * enc.frame_samples]
                sink.write(out)
                samples_out += len(out)
                if args.verbose and b0 % 64 == 63:
                    dt = max(time.monotonic() - t0, 1e-9)
                    print(f"\r{samples_out} samples, "
                          f"{samples_out / dt / 1e6:.1f} MS/s "
                          f"({samples_out / dt / sample_rate:.1f}x "
                          "realtime)", end="", file=sys.stderr)
                # the sink's audio side-channel (HackDAC interleave, FL2K
                # stereo/S/PDIF channels; src/hacktv.c:1586)
                if hasattr(sink, "write_audio"):
                    pcm = enc.block_audio_pcm(b0)
                    if pcm is not None and len(pcm):
                        sink.write_audio(pcm)
                frames_done += fpb
            pending = nxt
            if pending is None:
                break
            if frames and frames_done >= frames:
                break
    except (BrokenPipeError, KeyboardInterrupt):
        pass
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                args.profile, "hacktv_tpu_torch_trace.json"))
            print(f"profiler trace written to {args.profile}",
                  file=sys.stderr)
        sink.close()
        if args.verbose and hasattr(sink, "stats"):
            _print_sink_stats(sink.stats())
        if args.profile:
            _write_spans(args.profile, sink)
        if hasattr(source, "close"):
            source.close()
        if host_split is not None:
            _join_parts(args.output, host_split)
        if args.verbose and samples_out:
            dt = max(time.monotonic() - t0, 1e-9)
            print(f"\n{samples_out} samples in {dt:.2f} s = "
                  f"{samples_out / dt / 1e6:.1f} MS/s "
                  f"({samples_out / dt / sample_rate:.1f}x realtime)",
                  file=sys.stderr)
    return 0


def _print_sink_stats(st: dict) -> None:
    """-v's line at close: a hardware sink's underruns, or the file
    sink's bytes, conversion and wait times, most bytes in flight and
    writes borrowed."""
    if "underruns" in st:
        print(f"sink: {st['underruns']} underrun"
              f"{'s' if st['underruns'] != 1 else ''}, longest "
              f"{st['longest_shortfall_bytes']} bytes", file=sys.stderr)
    else:
        print(f"file sink: {st['bytes_in']} bytes in; converting "
              f"{st['convert_ns'] / 1e6:.1f} ms, waiting for room "
              f"{st['wait_ns'] / 1e6:.1f} ms, peak {st['peak_bytes']} "
              f"bytes in flight, borrowed writes {st['borrowed']}",
              file=sys.stderr)


def _write_spans(out_dir: str, sink) -> None:
    """--profile's record of the tracer (telemetry.take: the spans'
    totals and counts, the counters, the newest raw spans) and the
    sink's counts, as out_dir/hacktv_tpu_torch_spans.json; the tracer
    goes off."""
    rec = telemetry.take()
    telemetry.enable(False)
    if hasattr(sink, "stats"):
        rec["sink"] = sink.stats()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "hacktv_tpu_torch_spans.json"),
              "w") as f:
        json.dump(rec, f)


def _join_parts(part: str, host_split) -> None:
    """Mark this process's part done; process 0 waits for every part
    (600 s at most) and concatenates them, in host order, into the
    output, then removes the parts."""
    n_hosts, hid, base_out, _ = host_split
    open(part + ".done", "w").close()
    if hid:
        return
    parts = [f"{base_out}.part{j}" for j in range(n_hosts)]
    deadline = time.monotonic() + 600.0
    for pth in parts:
        while not os.path.exists(pth + ".done"):
            if time.monotonic() > deadline:
                raise SystemExit(f"--hosts: timed out waiting for {pth}")
            time.sleep(0.05)
    with open(base_out, "wb") as f:
        for pth in parts:
            with open(pth, "rb") as g:
                shutil.copyfileobj(g, f)
    for pth in parts:
        os.remove(pth)
        os.remove(pth + ".done")


def _mac_encoder(args, conf, sample_rate, pixel_rate, fpb, source,
                 devices=None):
    """The D/D2-MAC encoder the switches ask for (hacktv_tpu's MAC
    dispatch; its teletext keeps the wall clock, as there)."""
    from .video.mac import MacEncoder
    ec = None
    if args.eurocrypt:
        from .services.eurocrypt import Eurocrypt
        ec = Eurocrypt(args.eurocrypt, mat_rating=args.ec_mat_rating,
                       ppv=args.ec_ppv, nodate=args.nodate,
                       showecm=args.showecm)
    scr = 2 if args.double_cut else (1 if args.single_cut else 0)
    return MacEncoder(conf, sample_rate, pixel_rate, source=source,
                      frames_per_block=fpb, scramble_video=scr,
                      scramble_audio=args.scramble_audio, eurocrypt=ec,
                      teletext=args.teletext, device=args.device,
                      devices=devices)


def _encoder(args, conf, sample_rate, pixel_rate, fpb, source,
             devices=None):
    """The raster encoder with the services the switches ask for."""
    from .encoder import Encoder
    tt_clock = None
    if os.environ.get("HACKTV_TPU_TELETEXT_TIME"):
        tt_time = int(os.environ["HACKTV_TPU_TELETEXT_TIME"])
        tt_clock = lambda: tt_time
    return Encoder(conf, sample_rate, pixel_rate, source=source,
                   frames_per_block=fpb, teletext=args.teletext, teletext_clock=tt_clock,
                   wss=args.wss, vits=args.vits, vitc=args.vitc,
                   cc608=args.cc608, acp=args.acp, sis=args.sis,
                   videocrypt=args.videocrypt, videocrypt2=args.videocrypt2,
                   videocrypts=args.videocrypts, syster=args.syster,
                   systercnr=args.systercnr,
                   syster_key_table=(1 if args.key_table_1 else
                                     2 if args.key_table_2 else 0),
                   d11=args.d11, systeraudio=args.systeraudio,
                   vfilter=args.vfilter, a2stereo=args.a2stereo,
                   offset=int(args.offset), swap_iq=args.swap_iq,
                   passthru=args.passthru, raw_bb_file=args.raw_bb_file,
                   raw_bb_blanking=args.raw_bb_blanking,
                   raw_bb_white=args.raw_bb_white,
                   secam_exact=True if args.secam_exact else None,
                   device=args.device, devices=devices)


if __name__ == "__main__":
    sys.exit(main())
