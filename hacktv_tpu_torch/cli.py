"""Command-line interface: the subset of hacktv's options that the port
covers (port of hacktv_tpu/cli.py).

    python -m hacktv_tpu_torch -m i --frames 4 -o out.bin test

writes 4 frames of PAL-I with FM and NICAM-728 sound as interleaved int16
I/Q.  Accepted: -m MODE (the satellite FM modes pal-fm, ntsc-fm and
secam-fm among them), -s RATE, --filter, --noaudio, --nonicam,
--a2stereo, --swap-iq, --offset HZ, --passthru FILE, --raw-bb-file FILE,
--raw-bb-blanking N, --raw-bb-white N, --secam-field-id,
--secam-field-id-lines N, --secam-exact, -t TYPE, -o FILE, --frames N,
--device {cuda,cpu} and the input `test`.  The output goes through the
native runtime's threaded file sink (runtime.NativeFileSink), built at
first use; without a C++ compiler it raises.  Any other switch is
refused; modes and options that the port does not cover yet raise
NotImplementedError.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

import numpy as np

from .config.standards import get_mode


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hacktv_tpu_torch",
        description="analogue TV signal generator on an NVIDIA GPU "
                    "(hacktv-compatible subset)")
    a = p.add_argument
    a("input", nargs="*", default=["test"],
      help="input: 'test' (the test card) is the only source ported yet")
    a("-o", "--output", default="-",
      help="output: file:<path>, a bare path, or - for stdout")
    a("-m", "--mode", default="i", help="TV mode id")
    a("-s", "--samplerate", type=float, default=16e6)
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
    a("-t", "--type", default="int16",
      choices=["uint8", "int8", "uint16", "int16", "int32", "float"])
    a("--frames", type=int, default=0,
      help="stop after N frames (0 = until interrupted)")
    a("--device", default="cuda", choices=["cuda", "cpu"],
      help="where the encoder runs (default: the CUDA card)")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.input != ["test"]:
        raise NotImplementedError("only the 'test' input is ported yet")
    try:
        conf = get_mode(args.mode)
    except KeyError as e:
        raise SystemExit(str(e))
    if args.noaudio:
        conf = replace(conf, fm_mono_level=0.0, fm_left_level=0.0,
                       fm_right_level=0.0, am_audio_level=0.0,
                       nicam_level=0.0, dance_level=0.0)
    if args.nonicam:
        conf = replace(conf, nicam_level=0.0)
    if args.secam_field_id:
        conf = replace(conf, secam_field_id=True)
    if args.secam_field_id_lines is not None:
        conf = replace(conf, secam_field_id_lines=args.secam_field_id_lines)
    if args.a2stereo and conf.mac_mode is not None:
        raise SystemExit("a2stereo is not available for MAC modes")

    # 16 frames per block, or --frames if fewer
    fpb = min(16, args.frames) if args.frames else 16

    from .encoder import Encoder
    from .runtime import NativeFileSink
    enc = Encoder(conf, int(args.samplerate), frames_per_block=fpb,
                  vfilter=args.vfilter, a2stereo=args.a2stereo,
                  offset=int(args.offset), swap_iq=args.swap_iq,
                  passthru=args.passthru, raw_bb_file=args.raw_bb_file,
                  raw_bb_blanking=args.raw_bb_blanking,
                  raw_bb_white=args.raw_bb_white,
                  secam_exact=True if args.secam_exact else None,
                  device=args.device)
    target = args.output[5:] if args.output.startswith("file:") \
        else args.output
    sink = NativeFileSink(target, args.type, enc.complex_out)
    frames_done = 0
    block = 0
    try:
        # one-block pipeline: block b+1 is queued on the device before
        # block b is copied back and written
        pending = enc.encode_block_device(0)
        while pending is not None:
            nxt = None
            if not args.frames or frames_done + fpb < args.frames:
                nxt = enc.encode_block_device(block + 1)
            out = enc.collect_block(block, pending)
            if out.ndim == 1:
                out = np.stack([out, np.zeros_like(out)], axis=-1)
            if args.frames and frames_done + fpb > args.frames:
                out = out[: (args.frames - frames_done) * enc.frame_samples]
            sink.write(out)
            frames_done += fpb
            block += 1
            pending = nxt
    except (BrokenPipeError, KeyboardInterrupt):
        pass
    finally:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
