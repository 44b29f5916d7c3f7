#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Paths: m-vsb (Encoder("m", 13.5 MS/s, --filter)), pal-lowpass
(Encoder("pal", 16 MS/s, --filter)), pal-i (Encoder("i", 16 MS/s), the
flagship chain with FM and NICAM-728 sound), pal-i-vsb (the same with
--filter), secam-l-vsb (Encoder("l", 16 MS/s, --filter): SECAM colour, AM
sound and NICAM), g-a2 (Encoder("g", 16 MS/s, a2stereo=True): PAL-B/G
with A2 stereo), pal-fm-preemph (Encoder("pal-fm", 20.25 MS/s,
--filter): satellite FM video with the CCIR-405 pre-emphasis filter, the
host-exact video and sound carriers of the native runtime) and
mux-i-offset (MuxEncoder of two Encoder("i", 20 MS/s) at -2.25 and
+2.25 MHz: two PAL-I transmitters on one stream), pal-svideo-lowpass
(Encoder("pal", 16 MS/s, --filter, --s-video): luma and chroma on two
channels, each through the 51-tap low-pass) and i-pixelrate
(Encoder("i", 16 MS/s, pixel_rate=14.75 MS/s): the PAL-I chain
synthesised at 944 pixels a line and resampled to 1024 samples),
pal-i-teletext-vsb (Encoder("i", 16 MS/s, --filter, teletext from
tests/data/demo.tti, WSS 16:9, VITS, VITC): the UK terrestrial signal),
m-cc608-acp (Encoder("m", 13.5 MS/s, CEA-608, ACP, VITS, VITC): NTSC-M
with line-21 captions and copy protection) and i-sis (Encoder("i", 16
MS/s, sis="dcsis"): PAL-I with NICAM sound-in-syncs, coded by the
native runtime), i-videocrypt-vsb
(Encoder("i", 16 MS/s, --filter, videocrypt="free"): PAL-I scrambled for
Sky's Videocrypt decoders), l-syster-vsb (Encoder("l", 16 MS/s, --filter,
syster="premiere-fa", systeraudio=True): Canal+ France, Nagravision
Syster on SECAM-L with the sound inverted) and ntsc-bs
(Encoder("ntsc-bs", 16 MS/s): Japan's BS satellite, FM video with DANCE
digital sound); i-moving-vsb (Encoder("i", 16 MS/s, --filter) on moving
video: a 720x576 RGB32 file of 130 frames the script writes from a seed
into a temporary directory, with its .pcm sound and .cc608 captions,
read as the CLI reads `raw:FILE:720x576` with --repeat, each frame
stretched to 832x576; deleted at the end); and the D/D2-MAC paths (video/mac.py MacEncoder at 20.25
MS/s, W = 1296): d2mac-fm-ec (MacEncoder("d2mac-fm", eurocrypt=Eurocrypt(
"filmnet"), scramble_audio=True): European DBS satellite of the 1990s,
D2-MAC with Eurocrypt M, single cut), dmac-fm (MacEncoder("dmac-fm"):
BSB's UK D-MAC service, audio at address 128) and d2mac-am-dcut
(MacEncoder("d2mac-am", scramble_video=2): D2-MAC on cable, double
cut).  Teletext's clock and Eurocrypt's are fixed, and caption pairs are
queued with write_pair before the first block.

Phases, one line each (any failure exits non-zero before the result):

  1. card: name and power limit;
  2. build: the CUDA kernels from hacktv_tpu_torch/csrc, one nvcc each,
     and the native runtime from native/hacktv_rt.cpp with g++, all
     started together;
  3. kernels: each kernel against its plain PyTorch version at the
     shapes of each filtered path, on a stream laid out and offset as the
     encoder's (not 16-byte aligned), with the encoder's taps and with
     taps that take the other first-step branch: 0 mismatches required.
     Its time, achieved TB/s and TFLOP/s, the plain version's time, one
     PyTorch library call's (cuDNN conv1d, TF32 off), its bound and its
     share of it, its registers, shared memory and blocks per SM, and its
     SASS instruction mix;
  4. nicam: PAL-I's device frame coder (signs_device) at the 64-frame
     block's shapes against the port's host numpy coder, and nicam_add
     on the card against the same call on the CPU: byte-equal required;
     the card time of each;
  5. secam: SECAM-L's chroma program (device_chroma_carrier), luma
     band-reject and carrier add (render), both as the card's kernel
     (chroma_render) and AM carrier (am_add) at the 64-frame block's
     shapes on the card against the same calls on the CPU: byte-equal
     required; the card time of each, and the host time of one block's
     SECAM metadata (block_meta, built once per key);
  6. resample: the video resampler (device_resample_block) at
     i-pixelrate's 64-frame shape (L/M = 64/59, windows within a row) and
     at PAL 8 MS/s from 16 MS/s (L/M = 1/2, windows across rows) on the
     card against the same call on the CPU: byte-equal required; its card
     time, peak card memory and bytes bound;
  7. vbi: each VBI service of the three service paths at the 64-frame
     block's shapes: its host block_arrays per block, its apply on the
     card against the CPU (byte-equal required) and its card time;
     teletext's render against its bound, and with TF32 on (byte-equal
     to the CPU required); and sis-coder: SiS's block_arrays with the
     native NICAM coder and with numpy's, on two i-sis encoders in turns,
     and both coders alone on the same 2,560 frames: their host ms,
     byte-equal required;
  8. scramble: each scrambler of the scrambled paths and of Videocrypt
     S, Syster with cut-and-rotate and Discret 11 at the 64-frame
     block's shapes: its host block_arrays per block, its apply on the
     card against the CPU (byte-equal required) and its card time; and
     dance: ntsc-bs's host DANCE coder (frames, signs: dance_block) per
     block and its two-part pulse product (nicam_add) on the card
     against the CPU, with TF32 on (byte-equal required), and its card
     time; and mac: each MAC path at the 64-frame block's shapes, its
     host multiplex (_prepare_host) per block, the card step and within
     it the three duobinary products, the cut gather and FM, each timed
     alone; the products on the card with TF32 off and on against the
     CPU (byte-equal required), with their bytes and FLOP bound, and the
     step's peak card memory;
  9. end to end: each path at 64 frames per block, seeded noise for
     sound: 2 warm-up and 8 timed blocks (the host's enqueue time and the
     block time to the card's end; for FM video on the host, to the end
     of its collect_block, where the FM recurrence runs), with every
     kernel's launch count set to 0 just before a path and read just
     after; for pal-i-vsb and i-moving-vsb one more block under
     torch.profiler (its device ms, the card's idle share of the median
     block) and the step alone by CUDA events, and for i-moving-vsb the
     LUT's build and upload, a frame's read and fit, the 66-frame
     stack and upload and the card's conversion and gather (int32 and
     int64 indices); and bench: the port's measurement entry points
     (hacktv_tpu_torch.bench: --mode all, mux2, i --dynamic and --d2h;
     tools.service_bench's ten configurations; tools.profile_bench's
     host share of a 32-frame pal-i block), each JSON line as the entry
     point prints it, a trial a stream of blocks with one
     synchronisation at its end, and i --e2e file's sink: its blocks
     0-1 against a second encoder's collect_block (byte-identical
     required); dmac with its multiplex pipelined and not, in turns
     (mac-pipeline); the synchronising calls inside a block of each
     bench configuration, by source line (bench-syncs, torch's sync
     debug mode); and i --e2e null's block split into its dispatch,
     collection and sink write (bench-e2e-split);
  10. the card against the port's CPU path, one-frame blocks 0-3 of each
     path and of SECAM composite, SECAM-L (device and host-exact
     chroma), 405-line system A (AM sound), NTSC-M with A2 at 13.5135
     MS/s, SECAM-FM, NTSC-FM with its 71-tap pre-emphasis at 20.25 MS/s,
     PAL-FM with swap-IQ (FM video's device closed form), PAL-I at 20
     MS/s 2.25 MHz below centre, the rotated frames of Baird 30 and NBTV,
     field-sequential colour (Apollo, CBS 405), S-Video on SECAM and on
     PAL-I with its VSB filter, PAL at 8 MS/s from 16 MS/s pixels and
     PAL-FM at 20.25 MS/s from 13.5 MS/s pixels, and the services one at
     a time (WSS auto, VITS on PAL and NTSC and at 13.5135 MS/s, where
     the carrier comes from the angle addition, VITC on PAL-I and NTSC-M,
     ACP on PAL and NTSC, raw teletext packets, SiS with the VSB filter),
     and the scramblers (Videocrypt conditional, I and II together,
     Videocrypt S, Syster, cut-and-rotate alone and with Syster,
     Discret 11 on SECAM-L, SiS with the inverted sound), and the MAC
     configurations (the six modes, the cuts, scrambled audio, Eurocrypt
     EC-M and 3DES, MAC teletext from a page and from raw packets, mono
     medium-quality linear audio, 13.5 MHz pixels, a moving source in
     two-frame blocks, the pipelined multiplex), each with TF32 off and
     on: byte-identical required;
 11. moving: the LUT gather of one block's 66 frames against the host
     conversion, i-moving-vsb in 4-frame blocks against one-frame blocks,
     and eight moving configurations (i --filter, pal, l --filter, pal-fm,
     i --pixelrate, pal --s-video, ntsc --cc608 from the side-car,
     D2-MAC FM in two-frame blocks) card against CPU, blocks 0-3;
     checkpoint: seven e2e paths at 4 frames a block checkpointed at
     block 2 on the card and resumed on the card and on the CPU, blocks
     2-3 against the continuous run (0 differing values required);
     devices: the line-axis sharding (Encoder(devices=...)): pal-i-vsb
     at 64 frames a block (40,000 lines) on one device, then in 2 and 4
     shards on one card and, where there are several cards, on cuda:0-1
     and cuda:0-3 (with one card, a line says that no run across cards
     was made, which is not a failure): blocks 0-3 byte-identical to one
     device, then 6 blocks timed: the median block and enqueue ms, the
     card ms of each shard's row stage (CUDA events around it), peak
     card memory, fir_cplx launches (N a block required) and fir_cplx at
     the shard's shape against its plain version; and pal-lowpass,
     secam-l-vsb, l-syster-vsb, i-pixelrate, PAL 8 MS/s from 16 MS/s
     pixels, ntsc-bs, PAL-FM with swap-IQ, the mux's two PAL-I members
     at -2.25 and +2.25 MHz, d2mac-fm-ec and d2mac-am-dcut at 4 frames a
     block in 2 shards, blocks 0-3 byte-identical to one device, with
     fir_real at pal-lowpass's shard shape against its plain version;
     hosts: `-m i --filter --frames 32 --frames-per-block 8` in one
     process, then as `--hosts 2 --host 0` and `--host 1` at once: the
     joined file must hold the single process's bytes and no part may
     remain; each process's wall seconds;
 12. hw-sink: the hardware sinks fed from the card, each pulled by
     PacedLib, a fake libhackrf/libosmo-fl2k whose thread calls the
     driver's ctypes callback at the device's clock (262,144-byte HackRF
     transfers, 1,310,720-sample FL2K transfers): pal-i-vsb through the
     command line (-m i --filter -f 855250000 -g 47 -o hackrf, 200 frames,
     rf/hardware.py's _find_lib returning the fake while it runs),
     i-moving-vsb through open_sink("hackrf") at 8 and at 64 frames a
     block (192 frames of the moving file), pal-lowpass through
     open_sink("fl2k") (112 frames, fir_real).  Each run's seconds of
     signal and wall seconds, underruns before and after the FIFO's
     prefill, the longest shortfall, the FIFO's lowest level after the
     prefill, the callback's p99 lateness, bytes pulled and launches.  A
     run with no underrun after the prefill must pull the producer's
     conversion of its blocks; pal-i-vsb must have none;
 13. the command line (three processes at a time on the card), 4
     frames each of -m i, -m i --filter with
     teletext, WSS, VITS and VITC, -m pal-fm --filter, -m pal --s-video
     --filter, -m i --pixelrate 14750000, -m i --filter --videocrypt
     free, -m i --filter --sis dcsis, -m ntsc-bs, -m d2mac-fm --eurocrypt ctv and -m dmac
     --double-cut, and 128 frames of the moving file with -m i --filter
     (and --letterbox), to files through the native sink; and -o hackrf
     with no HackRF: a non-zero exit naming libhackrf, no file.

A `[total]` line gives the run's wall seconds.  The line before the
last is {"kernels": [...]}, each kernel with its launches on the e2e
path, the hw-sink runs and the sharded paths (`sharded_launches`); the
last line is {"ok": true, "device": {...}}.  With --profile DIR, one
block of each path is traced with torch.profiler and its kernel times
written to DIR.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from dataclasses import replace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
F64_FLOP_PER_S = 67e12         # H100 SXM f64 on the tensor cores
FPB = 64                       # frames per block on the main path
TIMED_BLOCKS = 8
WARM_BLOCKS = 2
# path: (mode, sample rate, --filter, other Encoder arguments); "mux" is a
# MuxEncoder of one such encoder per frequency offset, "s_video" sets the
# mode's S-Video switch
MUX_OFFSETS = (-2_250_000, 2_250_000)
PATHS = {"m-vsb": ("m", 13_500_000, True, {}),
         "pal-lowpass": ("pal", 16_000_000, True, {}),
         "pal-i": ("i", 16_000_000, False, {}),
         "pal-i-vsb": ("i", 16_000_000, True, {}),
         "secam-l-vsb": ("l", 16_000_000, True, {}),
         "g-a2": ("g", 16_000_000, False, {"a2stereo": True}),
         "pal-fm-preemph": ("pal-fm", 20_250_000, True, {}),
         "mux-i-offset": ("i", 20_000_000, False, {"mux": MUX_OFFSETS}),
         "pal-svideo-lowpass": ("pal", 16_000_000, True, {"s_video": True}),
         "i-pixelrate": ("i", 16_000_000, False,
                         {"pixel_rate": 14_750_000}),
         "pal-i-teletext-vsb": ("i", 16_000_000, True, {
             "teletext": "tests/data/demo.tti", "wss": "16:9",
             "vits": True, "vitc": True}),
         "m-cc608-acp": ("m", 13_500_000, False, {
             "cc608": True, "acp": True, "vits": True, "vitc": True}),
         "i-sis": ("i", 16_000_000, False, {"sis": "dcsis"}),
         "i-videocrypt-vsb": ("i", 16_000_000, True, {"videocrypt": "free"}),
         "l-syster-vsb": ("l", 16_000_000, True, {
             "syster": "premiere-fa", "systeraudio": True}),
         "ntsc-bs": ("ntsc-bs", 16_000_000, False, {})}
# the card against the CPU: the paths and these
CPU_PATHS = {**PATHS,
             "secam": ("secam", 16_000_000, False, {}),
             "l": ("l", 16_000_000, False, {}),
             "a": ("a", 16_000_000, False, {}),
             "m-a2": ("m", 13_513_500, False, {"a2stereo": True}),
             "secam-fm": ("secam-fm", 16_000_000, False, {}),
             "ntsc-fm-preemph": ("ntsc-fm", 20_250_000, True, {}),
             "pal-fm-swap": ("pal-fm", 16_000_000, False, {"swap_iq": True}),
             "i-offset": ("i", 20_000_000, False, {"offset": -2_250_000}),
             "i-offset-up": ("i", 20_000_000, False, {"offset": 2_250_000}),
             "l-secam-exact": ("l", 16_000_000, False,
                               {"secam_exact": True}),
             "30": ("30", 100_000, False, {}),
             "nbtv-am": ("nbtv-am", 100_000, False, {}),
             "apollo-fsc": ("apollo-fsc", 14_000_000, False, {}),
             "apollo-fsc-fm": ("apollo-fsc-fm", 13_500_000, False, {}),
             "cbs405": ("cbs405", 9_000_000, False, {}),
             "m-cbs405": ("m-cbs405", 14_000_000, False, {}),
             "secam-svideo": ("secam", 16_000_000, False, {"s_video": True}),
             "i-svideo-vsb": ("i", 16_000_000, True, {"s_video": True}),
             "pal-8-from-16": ("pal", 8_000_000, False,
                               {"pixel_rate": 16_000_000}),
             "pal-fm-pixelrate": ("pal-fm", 20_250_000, False,
                                  {"pixel_rate": 13_500_000}),
             "pal-wss-auto": ("pal", 16_000_000, False, {"wss": "auto"}),
             "pal-vits": ("pal", 16_000_000, False, {"vits": True}),
             "ntsc-vits": ("ntsc", 13_500_000, False, {"vits": True}),
             # no exact carrier rows at this rate: VITS reads the
             # angle-addition carrier
             "pal-vits-angle": ("pal", 13_513_500, False, {"vits": True}),
             "m-vits-angle": ("m", 13_513_500, False, {"vits": True}),
             "i-vitc": ("i", 16_000_000, False, {"vitc": True}),
             "m-vitc": ("m", 13_500_000, False, {"vitc": True}),
             "pal-acp": ("pal", 16_000_000, False, {"acp": True}),
             "ntsc-acp": ("ntsc", 13_500_000, False, {"acp": True}),
             "pal-teletext-raw": ("pal", 16_000_000, False, {
                 "teletext": "raw:tests/data/raw_tt_packets.bin"}),
             "i-sis-vsb": ("i", 16_000_000, True, {"sis": "dcsis"}),
             "pal-videocrypt-conditional": ("pal", 16_000_000, False, {
                 "videocrypt": "conditional"}),
             "pal-videocrypt-1-2": ("pal", 16_000_000, False, {
                 "videocrypt": "free", "videocrypt2": "free"}),
             "i-videocrypts": ("i", 16_000_000, False,
                               {"videocrypts": "free"}),
             "pal-syster": ("pal", 16_000_000, False,
                            {"syster": "premiere-fa"}),
             "pal-systercnr": ("pal", 16_000_000, False,
                               {"systercnr": "premiere-fa"}),
             "pal-syster-systercnr": ("pal", 16_000_000, False, {
                 "syster": "premiere-fa", "systercnr": "premiere-fa"}),
             "l-d11": ("l", 16_000_000, False, {"d11": "premiere-fa"}),
             "i-sis-systeraudio": ("i", 16_000_000, False, {
                 "sis": "dcsis", "systeraudio": True})}
# D/D2-MAC paths (video/mac.py MacEncoder): (mode, sample rate, arguments);
# "eurocrypt" names a provider (made with EUROCRYPT_TIME as its clock),
# "conf" overrides the mode's configuration, "moving" sets a seeded
# moving source, "fpb" the frames per block of the card-vs-CPU check
MAC_RATE = 20_250_000
MAC_PATHS = {"d2mac-fm-ec": ("d2mac-fm", MAC_RATE, {
                 "eurocrypt": "filmnet", "scramble_audio": True}),
             "dmac-fm": ("dmac-fm", MAC_RATE, {}),
             "d2mac-am-dcut": ("d2mac-am", MAC_RATE, {"scramble_video": 2})}
# the card against the CPU: the MAC paths and these
MAC_CPU_PATHS = {**MAC_PATHS,
                 "d2mac": ("d2mac", MAC_RATE, {}),
                 "d2mac-fm": ("d2mac-fm", MAC_RATE, {}),
                 "dmac": ("dmac", MAC_RATE, {}),
                 "dmac-am": ("dmac-am", MAC_RATE, {}),
                 "d2mac-scut": ("d2mac", MAC_RATE, {"scramble_video": 1}),
                 "dmac-dcut": ("dmac", MAC_RATE, {"scramble_video": 2}),
                 "d2mac-scramble-audio": ("d2mac", MAC_RATE,
                                          {"scramble_audio": True}),
                 "dmac-fm-cplus": ("dmac-fm", MAC_RATE,
                                   {"eurocrypt": "cplus"}),
                 "d2mac-teletext": ("d2mac", MAC_RATE,
                                    {"teletext": "tests/data/demo.tti"}),
                 "d2mac-teletext-raw": ("d2mac", MAC_RATE, {
                     "teletext": "raw:tests/data/raw_tt_packets.bin"}),
                 "d2mac-mono-mq-linear-l2": ("d2mac", MAC_RATE, {"conf": {
                     "mac_audio_stereo": False, "mac_audio_quality": False,
                     "mac_audio_companded": False,
                     "mac_audio_protection": True}}),
                 "d2mac-pixelrate": ("d2mac", MAC_RATE,
                                     {"pixel_rate": 13_500_000}),
                 "d2mac-moving-2f": ("d2mac", MAC_RATE,
                                     {"moving": True, "fpb": 2}),
                 "dmac-fm-pipelined": ("dmac-fm", MAC_RATE,
                                       {"pipeline_mux": True})}
EUROCRYPT_TIME = 1_200_000_000
# the moving path: a raw RGB32 file of MOTION_FRAMES seeded 720x576 frames
# (a shifted gradient with noise, saturated bands on top) with its .pcm
# sound and .cc608 captions, written into a temporary directory, each
# frame stretched to the mode's active picture and the file looped: the
# CLI's input chain for `raw:FILE:720x576`
MOTION_FRAMES = 130
MOTION_SIZE = (720, 576)
MOTION_SEED = 2024
MOTION = {}                    # "path": the file, while the run lasts
MOVING_PATHS = {"i-moving-vsb": ("i", 16_000_000, True, {})}
# the hw-sink phase: libhackrf's transfer (bytes) and libosmo-fl2k's
# FL2K_BUF_LEN (samples a channel); the command line's pal-i-vsb run (8 s
# of signal in its 16-frame blocks); the frames of the moving runs and
# their frames a block, and the frames of the FL2K run
HACKRF_TRANSFER = 262_144
FL2K_TRANSFER = 1_310_720
HW_SINK_CLI = ["-m", "i", "--filter", "-f", "855250000", "-g", "47", "-o",
               "hackrf", "--frames", "200", "test"]
HW_MOVING_FRAMES = 192
HW_MOVING_FPB = (8, 64)
HW_LOWPASS_FRAMES = 112
# the moving phase: card against CPU on the moving file, MOVING_FPB-frame
# blocks 0-3 (SECAM on one frame a block, glibc's large sin/cos)
MOVING_FPB = 4
MOVING_CPU_PATHS = {
    "i-filter": ("i", 16_000_000, True, {}),
    "pal": ("pal", 16_000_000, False, {}),
    "l-filter": ("l", 16_000_000, True, {}),
    "pal-fm": ("pal-fm", 20_250_000, False, {}),
    "i-pixelrate": ("i", 16_000_000, False, {"pixel_rate": 14_750_000}),
    "pal-svideo": ("pal", 16_000_000, False, {"s_video": True}),
    "ntsc-cc608": ("ntsc", 13_500_000, False, {"cc608": True})}
# the checkpoint phase: these e2e paths at MOVING_FPB frames a block
CHECKPOINT_PATHS = ("pal-i", "secam-l-vsb", "pal-fm-preemph",
                    "i-videocrypt-vsb", "i-sis", "pal-i-teletext-vsb",
                    "d2mac-fm-ec")
# the paths whose card step and idle share the e2e phase measures
BUSY_PATHS = ("pal-i-vsb", "i-moving-vsb")
# the scramble phase: the scrambled e2e paths and these
SCRAMBLE_PATHS = ("i-videocrypt-vsb", "l-syster-vsb", "i-videocrypts",
                  "pal-syster-systercnr", "l-d11")
# the devices phase: pal-i-vsb at FPB frames a block in these numbers of
# shards on one card (and on the cards present, when more than one),
# blocks 0-3 against one device and DEVICE_TIMED more timed; and these
# configurations at MOVING_FPB frames a block in 2 shards, blocks 0-3
# against one device (the mux's two members one at a time)
DEVICE_SHARDS = (2, 4)
DEVICE_TIMED = 6
SHARDED_PATHS = ("pal-lowpass", "secam-l-vsb", "l-syster-vsb",
                 "i-pixelrate", "pal-8-from-16", "ntsc-bs", "pal-fm-swap",
                 "i-offset", "i-offset-up", "d2mac-fm-ec", "d2mac-am-dcut")
# the cli phase's runs, this many processes at once
CLI_AT_ONCE = 3
# the hosts phase: the command line in two processes at once
HOSTS_ARGS = ["-m", "i", "--filter", "--frames", "32",
              "--frames-per-block", "8"]
# one-frame blocks 0-3: SECAM's carry three times, every field of the
# field-sequential modes, the second block of each
CPU_BLOCKS = 4
HERE = os.path.dirname(os.path.abspath(__file__))
# teletext's header time, fixed so that the card and the CPU write the
# same pages (unix seconds)
TELETEXT_TIME = 1_200_000_000
# CEA-608 pairs queued with write_pair before the first block
CAPTIONS = [(0x14, 0x20), (0x48, 0x49), (0x21, 0x7F), (0x14, 0x2F)]


def teletext_clock():
    return TELETEXT_TIME


def build(spec, device, source=None, frames_per_block=1):
    """The encoder (or mux of encoders) of a PATHS/CPU_PATHS entry."""
    from hacktv_tpu_torch.config import get_mode
    from hacktv_tpu_torch.encoder import Encoder
    from hacktv_tpu_torch.mux import MuxEncoder
    mode, rate, vfilter, kw = spec
    kw = dict(kw)
    offsets = kw.pop("mux", None)
    if kw.pop("s_video", False):
        mode = replace(get_mode(mode), s_video=True)
    if "teletext" in kw:
        # tests/data is found beside this script, not in the working
        # directory
        tt = kw["teletext"]
        raw = tt.startswith("raw:")
        kw["teletext"] = ("raw:" if raw else "") + os.path.join(
            HERE, tt[4:] if raw else tt)
        kw["teletext_clock"] = teletext_clock
    mk = lambda **extra: Encoder(mode, rate, vfilter=vfilter, source=source,
                                 frames_per_block=frames_per_block,
                                 device=device, **kw, **extra)
    if offsets is not None:
        return MuxEncoder([mk(offset=o) for o in offsets])
    enc = mk()
    for svc in enc.services:
        if hasattr(svc, "write_pair"):
            for pair in CAPTIONS:
                svc.write_pair(*pair)
    return enc


def build_mac(spec, device, source=None, frames_per_block=1):
    """The MacEncoder of a MAC_PATHS/MAC_CPU_PATHS entry."""
    from hacktv_tpu_torch.config import get_mode
    from hacktv_tpu_torch.services.eurocrypt import Eurocrypt
    from hacktv_tpu_torch.video.mac import MacEncoder
    mode, rate, kw = spec
    kw = dict(kw)
    kw.pop("fpb", None)
    if kw.pop("moving", False):
        from hacktv_tpu_torch.av.noise import MovingNoiseSource
        source = MovingNoiseSource(*MacEncoder.active_geometry(
            get_mode(mode), rate))
    conf = get_mode(mode)
    if "conf" in kw:
        conf = replace(conf, **kw.pop("conf"))
    if "eurocrypt" in kw:
        kw["eurocrypt"] = Eurocrypt(kw["eurocrypt"], now=EUROCRYPT_TIME)
    if "teletext" in kw:
        tt = kw["teletext"]
        raw = tt.startswith("raw:")
        kw["teletext"] = ("raw:" if raw else "") + os.path.join(
            HERE, tt[4:] if raw else tt)
        kw["teletext_clock"] = teletext_clock
    return MacEncoder(conf, rate, source=source,
                      frames_per_block=frames_per_block, device=device, **kw)


def make_path(path, device, frames_per_block):
    """A PATHS or MAC_PATHS entry's encoder on seeded noise sound, or a
    MOVING_PATHS entry's on the moving file, with its sample rate and
    whether it runs the video filter."""
    if path in MOVING_PATHS:
        spec = MOVING_PATHS[path]
        return (build(spec, device, motion_source(
            spec[0], spec[1], spec[3].get("pixel_rate", 0)),
            frames_per_block), spec[1], spec[2])
    if path in MAC_PATHS:
        spec = MAC_PATHS[path]
        return (build_mac(spec, device, mac_noise_source(spec),
                          frames_per_block), spec[1], False)
    spec = PATHS[path]
    return (build(spec, device, noise_source(spec), frames_per_block),
            spec[1], spec[2])


def write_motion(dirname: str) -> str:
    """The moving file: MOTION_FRAMES frames of 0xAARRGGBB pixels from
    MOTION_SEED (a gradient shifted 8 pixels a frame, seeded noise, and
    48 rows on top of one saturated colour a frame, cyan, green or
    yellow, which take SECAM's carrier phase past 120 rad), its .pcm
    side-car (seeded noise) and its .cc608 side-car (one pair a
    frame)."""
    rng = np.random.default_rng(MOTION_SEED)
    w, h = MOTION_SIZE
    x = np.arange(w, dtype=np.int64)[None, :]
    y = np.arange(h, dtype=np.int64)[:, None]
    bands = np.array([[0, 255, 255], [0, 255, 0], [255, 255, 0]], np.int64)
    path = os.path.join(dirname, "motion.raw")
    with open(path, "wb") as f:
        for n in range(MOTION_FRAMES):
            noise = rng.integers(0, 24, (3, h, w))
            r = (x + 8 * n) % 232 + noise[0]
            g = (y + 3 * n) % 232 + noise[1]
            b = ((x + y) // 2 + 5 * n) % 232 + noise[2]
            r[:48], g[:48], b[:48] = bands[n % 3]
            px = (0xFF << 24) | (r << 16) | (g << 8) | b
            f.write(px.astype(np.uint32).tobytes())
    pairs = MOTION_FRAMES * 32000 // 25
    rng.integers(-20000, 20000, (pairs, 2)).astype(np.int16).tofile(
        path + ".pcm")
    cc = np.array([[0x41 + n % 26, 0x61 + n % 26]
                   for n in range(MOTION_FRAMES)], np.uint8)
    cc.tofile(path + ".cc608")
    return path


def motion_source(mode, rate, pixel_rate=0):
    """The moving file as the CLI reads `raw:FILE:720x576` with --repeat:
    each frame stretched to the mode's active picture, the file
    reopened at its end."""
    from hacktv_tpu_torch.av.frame_ops import FitConfig, FitSource
    from hacktv_tpu_torch.av.rawfile import RawFileSource
    from hacktv_tpu_torch.av.sequence import SequenceSource
    from hacktv_tpu_torch.config import get_mode
    from hacktv_tpu_torch.video.mac import MacEncoder
    from hacktv_tpu_torch.video.params import VideoParams
    conf = get_mode(mode)
    if conf.mac_mode is not None:
        aw, al = MacEncoder.active_geometry(conf, rate, pixel_rate)
    else:
        aw = VideoParams.create(conf, rate, pixel_rate).active_width
        al = conf.active_lines
    cfg = FitConfig(aw, al, fit_mode="stretch")
    spec = "{}:{}x{}".format(MOTION["path"], *MOTION_SIZE)
    return SequenceSource([lambda: FitSource(RawFileSource(spec, aw, al),
                                             cfg)], repeat=True)


def mac_noise_source(spec):
    """Seeded noise sound on the test card, sized for the MAC mode."""
    from hacktv_tpu_torch.av.noise import NoiseSource
    from hacktv_tpu_torch.config import get_mode
    from hacktv_tpu_torch.video.mac import MacEncoder
    aw, al = MacEncoder.active_geometry(get_mode(spec[0]), spec[1],
                                        spec[2].get("pixel_rate", 0))
    return NoiseSource(aw, al)


def noise_source(spec):
    """Seeded noise sound on the test card, sized for the path's mode at
    its pixel rate (with its sides swapped for a quarter-turn mode, whose
    frames the encoder rotates)."""
    from hacktv_tpu_torch.av.noise import NoiseSource
    from hacktv_tpu_torch.config import get_mode
    from hacktv_tpu_torch.video.params import VideoParams
    conf = get_mode(spec[0])
    p = VideoParams.create(conf, spec[1], spec[3].get("pixel_rate", 0))
    if (conf.frame_orientation & 3) in (1, 3):
        return NoiseSource(conf.active_lines, p.active_width)
    return NoiseSource(p.active_width, conf.active_lines)


def fir_launches(since: dict | None = None) -> dict:
    """Each stream-FIR kernel's launches, by kernel: the program's
    counters "fir_cplx.launches" and "fir_real.launches"
    (hacktv_tpu_torch/telemetry.py), since the counts `since`."""
    from hacktv_tpu_torch import telemetry
    c = telemetry.counters()
    now = {k: c.get(k + ".launches", 0) for k in ("fir_cplx", "fir_real")}
    return now if since is None else {k: now[k] - since[k] for k in now}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(tag: str, **kv) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


LAP = {}                       # "t": the clock at the last lap


def lap(name: str) -> None:
    """One line with the wall seconds since the last lap: what each
    phase costs of the run's time limit."""
    now = time.perf_counter()
    phase("seconds", after=name, seconds=f"{now - LAP.get('t', now):.1f}")
    LAP["t"] = now


def cuda_ms(fn, reps: int, train: int = 1) -> float:
    """Device time of one fn() call by CUDA events: the median over reps
    trains of `train` back-to-back calls, each train's time divided by
    its length.  A train keeps the card busy while the host enqueues the
    next call, so a short kernel is not timed with its launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(train):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / train)
    return statistics.median(times)


CARD = {}                      # nvidia-smi's name and power limit


def card() -> str:
    from hacktv_tpu_torch.bench import card_line
    name = torch.cuda.get_device_name(0)
    try:
        line = card_line()
    except RuntimeError as e:
        fail(str(e))
    print(line, flush=True)
    CARD["smi"] = line
    phase("card", name=json.dumps(name), count=torch.cuda.device_count())
    return name


def other_branch(sf, taps: torch.Tensor) -> torch.Tensor:
    """A copy of host taps whose first fused step takes the other branch
    (r = taps reversed; ops.stream_fir.fuse_second)."""
    t = taps.clone()
    r0, r1 = float(t[-1]), float(t[-2])
    if sf.fuse_second(r0, r1):
        t[-1] = abs(r0)
    else:
        t[-1] = -(abs(r0) or 0.01)
        t[-2] = abs(r1) or 0.01
    return t


def sass_mix(lib: str) -> None:
    """Print each stream-FIR kernel's SASS instruction counts (cuobjdump
    of the built library)."""
    import collections
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        r = subprocess.run([tool, "-sass", lib], capture_output=True,
                           text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"cuobjdump -sass did not run: {e}")
    if r.returncode != 0:
        fail(f"cuobjdump -sass exited {r.returncode}: {r.stderr[-500:]}")
    sass = r.stdout
    name, mix = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : \S*stream_fir_kernelILi(\d)ELi(\d+)E",
                      line)
        if m:
            name = ("cplx" if m.group(1) == "2" else "real") + (
                f",nt={m.group(2)}" if m.group(2) != "0" else ",nt=runtime")
            mix[name] = collections.Counter()
            continue
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)", line)
        if name and op:
            mix[name][op.group(1)] += 1
    if len(mix) != 4:
        fail(f"cuobjdump -sass showed {len(mix)} stream-FIR kernels, not 4")
    for name, c in mix.items():
        phase("sass", kernel=name, instructions=sum(c.values()),
              **{k: v for k, v in c.most_common(8)})


def kernel_phase(sf, VideoParams, get_mode) -> list:
    """Each kernel against its plain version at the main path's shapes,
    on a stream laid out as the encoder's: a block of lines with a halo
    line before it, the filter reading from half a filter before the
    block, which leaves xs 4 or 12 bytes past a 16-byte boundary."""
    from dataclasses import replace
    out = []
    gen = torch.Generator(device="cuda").manual_seed(2024)
    for path, (mode, rate, vfilter, _) in {**PATHS, **MOVING_PATHS}.items():
        if not vfilter:
            continue
        p = VideoParams.create(replace(get_mode(mode), vfilter=True), rate, 0)
        W = p.width
        n = FPB * p.conf.lines * W
        if p.vfilter_ctaps is not None:
            taps = [torch.as_tensor(np.ascontiguousarray(a))
                    for a in (p.vfilter_ctaps.real, p.vfilter_ctaps.imag)]
            name, fn, src_line = "stream_fir_cplx", sf.fir_cplx, \
                "hacktv_tpu/ops/pallas_fir.py:89"
        else:
            taps = [torch.as_tensor(p.vfilter_taps)]
            name, fn, src_line = "stream_fir_real", sf.fir_real, \
                "hacktv_tpu/ops/pallas_fir.py:102"
        nt = taps[0].shape[0]
        half = nt // 2
        # the raster's range: int16-scaled composite
        x = torch.randn(n + 2 * W, generator=gen, device="cuda") * 8000.0
        xs = x[W - half: W - half + n + nt - 1]
        skew = xs.data_ptr() % 16
        err, mism, branches = 0.0, 0, []
        for variant in (taps, [other_branch(sf, t) for t in taps]):
            got = fn(xs, *variant, n)
            torch.cuda.synchronize()
            plain = sf.stream_fir_plain(
                xs, variant[0], variant[1] if len(variant) > 1 else None, n)
            got = got if isinstance(got, tuple) else (got,)
            plain = plain if isinstance(plain, tuple) else (plain,)
            for a, b in zip(got, plain):
                err = max(err, float((a - b).abs().max()))
                mism += int((a != b).sum())
            branches.append("/".join(
                "fuse2" if sf.fuse_second(float(t[-1]), float(t[-2]))
                else "fuse1" for t in variant))
            del got, plain
        args = (xs, *taps, n)
        ms = cuda_ms(lambda: fn(*args), 5, train=20)
        plain_ms = cuda_ms(lambda: sf.stream_fir_plain(
            xs, taps[0], taps[1] if len(taps) > 1 else None, n), 3)
        torch.backends.cudnn.allow_tf32 = False
        w = torch.stack([t.flip(0) for t in taps])[:, None, :].cuda()
        x3 = xs[None, None, :]
        lib = torch.nn.functional.conv1d(x3, w)[0]
        got = fn(*args)
        got = got if isinstance(got, tuple) else (got,)
        lib_err = max(float((lib[i] - got[i]).abs().max())
                      for i in range(len(got)))
        library_ms = cuda_ms(lambda: torch.nn.functional.conv1d(x3, w), 3,
                             train=10)
        nout = len(taps)
        nbytes = 4 * ((n + nt - 1) + nout * nt + nout * n)
        flops = 2 * nt * n * nout
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        cfg = sf.kernel_config(nout == 2, nt)
        rec = dict(name=name, path=path, n=n, route="cuda",
                   source="hacktv_tpu_torch/csrc/stream_fir.cu",
                   replaces=src_line, launches=0, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=library_ms, bound_share=bound_ms / ms)
        phase("kernel", name=name, path=path, n=n, taps=nt,
              xs_offset_bytes_past_16=skew, branches=",".join(branches),
              mismatches=mism, max_abs_err=err, ms=f"{ms:.4f}",
              tb_per_s=f"{nbytes / ms / 1e9:.3f}",
              tflop_per_s=f"{flops / ms / 1e9:.2f}",
              bound_ms=f"{bound_ms:.4f}", bound_by=rec["bound_by"],
              bound_share=f"{bound_ms / ms:.3f}",
              plain_ms=f"{plain_ms:.3f}", conv1d_ms=f"{library_ms:.4f}",
              conv1d_max_abs_diff=lib_err, bytes=nbytes, flop=flops,
              regs=cfg["regs"], smem_bytes=cfg["smem_bytes"],
              blocks_per_sm=cfg["blocks_per_sm"])
        if mism:
            fail(f"{name}: {mism} outputs differ from its plain version "
                 f"(max |a-b| {err})")
        out.append((path, rec))
        del x, xs, got, lib
        torch.cuda.empty_cache()
    return out


def nicam_phase(Encoder) -> None:
    """PAL-I's NICAM at the 64-frame block's shapes.  The device frame
    coder from the stream start (frames 0..nf_max-1) against the port's
    host numpy coder, and nicam_add of those signs on the card against
    the same call on the CPU, each byte for byte; then the card time of
    each (CUDA events)."""
    from hacktv_tpu_torch.audio import nicam as nm
    from hacktv_tpu_torch.audio import nicam_dev, synth
    encs = {d: Encoder("i", 16_000_000, frames_per_block=FPB, device=d)
            for d in ("cuda", "cpu")}
    nlines = FPB * 625
    audio = np.random.default_rng(9).integers(-32768, 32768, (
        encs["cpu"].nicam_dev_statics.nf_max * 32, 2)).astype(np.int16)
    res = {}
    for d, e in encs.items():
        st, dst = e.nicam_statics, e.nicam_dev_statics
        nc = e.audio.nicam_device_block(0, nlines, st, dst, None)
        # frame 0 is the modulator's initial silence; frame f carries
        # pairs [32(f-1), 32f), behind 82 rows of J.17 history
        pcm = np.concatenate([np.zeros((32 + 82, 2), np.int16),
                              audio[:(dst.nf_max - 1) * 32]])
        dev_args = (dst, torch.as_tensor(pcm, device=d),
                    torch.zeros((), dtype=torch.int32, device=d), 0,
                    nc["base_off"], nc["nkeep"])
        si, sq, ds = nicam_dev.signs_device(*dev_args)
        y = torch.zeros((nlines, 1024), device=d)
        add_args = (st, y, y, si, sq, nc["offq"], nc["offr"],
                    torch.as_tensor(nc["cc_off"], device=d), 0)
        oi, oq = synth.nicam_add(*add_args)
        res[d] = [t.cpu().numpy() for t in (si, sq, ds, oi, oq)]
        if d == "cuda":
            ms_signs = cuda_ms(lambda: nicam_dev.signs_device(*dev_args), 5)
            ms_add = cuda_ms(lambda: synth.nicam_add(*add_args), 5)
            n_keep = nc["nkeep"]
            off = nc["base_off"]
    pairs = nm.frame_symbols(nm.encode_frames(pcm.astype(np.int64), 0)
                             ).reshape(-1)
    host, _ = nm.differential_encode(pairs, 0)
    _, dsym = nm.differential_encode(pairs[:n_keep], 0)
    si, sq, ds = res["cuda"][:3]
    n = len(pairs)
    host_diff = (int(np.count_nonzero(si[off:off + n] != host[:, 0]))
                 + int(np.count_nonzero(sq[off:off + n] != host[:, 1]))
                 + int(int(ds) != dsym))
    cpu_diff = {name: int(np.count_nonzero(a != b)) for name, a, b in zip(
        ("signs_i", "signs_q", "dsym", "out_i", "out_q"), res["cuda"],
        res["cpu"])}
    phase("nicam", frames=dst.nf_max, symbols=n, kept=n_keep,
          signs_vs_host_coder_differing=host_diff,
          card_vs_cpu_differing=json.dumps(cpu_diff).replace(" ", ""),
          signs_device_ms=f"{ms_signs:.3f}", nicam_add_ms=f"{ms_add:.3f}",
          lines=nlines)
    if host_diff or any(cpu_diff.values()):
        fail("nicam: the card differs from the host coder or the CPU path")
    del encs, res
    torch.cuda.empty_cache()


def secam_phase(Encoder) -> None:
    """SECAM-L's own layers at the 64-frame block's shapes (block 1, the
    test card, a carried z, seeded sound and video): the chroma program
    (device_chroma_carrier), the luma band-reject and carrier add
    (render), both through the card's kernel (chroma_render; the plain
    pair on the CPU) and the AM carrier (am_add), on the card and on the
    CPU: byte-equal required; then the card time of each (CUDA
    events)."""
    from hacktv_tpu_torch.audio import synth
    from hacktv_tpu_torch.video import raster, secam
    res, ms = {}, {}
    for d in ("cuda", "cpu"):
        e = Encoder("l", 16_000_000, frames_per_block=FPB, device=d)
        p = e.params
        nl = FPB * p.lines
        t = time.perf_counter()
        nm = secam.block_meta(p, nl - 1, nl + 2, nl, e.vframe_y,
                              e.source.height)
        # the host's build of one new metadata key (a loop over the lines)
        meta_s = time.perf_counter() - t
        _, u, v = raster.rgb_to_yuv_host(p, e.source.read_video(0), True)
        meta = secam.meta_to_device(nm, d)
        chroma = (e.secam, meta, torch.as_tensor(u, device=d),
                  torch.as_tensor(v, device=d),
                  torch.tensor(-1234.5, device=d))
        add, z = secam.device_chroma_carrier(*chroma)
        rng = np.random.default_rng(12)
        video = torch.as_tensor(rng.integers(-9000, 23000, (
            nl + 2, p.width)).astype(np.float32), device=d)
        rendered = secam.render(e.secam, video, add, meta)
        kern, kz = secam.chroma_render(*chroma, video)
        am = {k: torch.as_tensor(np.ascontiguousarray(a), device=d)
              for k, a in e.audio.am_block(e.audio.am_mono, 1, nl).items()}
        am_args = (e.am_statics, video[1:nl + 1], video[:nl],
                   am["seg_val"], am["seg_col"], am["c0"], am["s0"])
        ai, aq = synth.am_add(*am_args)
        res[d] = [t.cpu().numpy()
                  for t in (add, z, rendered, kern, kz, ai, aq)]
        if d == "cuda":
            ms["device_chroma_carrier"] = cuda_ms(
                lambda: secam.device_chroma_carrier(*chroma), 5)
            ms["render"] = cuda_ms(
                lambda: secam.render(e.secam, video, add, meta), 5)
            ms["chroma_render"] = cuda_ms(
                lambda: secam.chroma_render(*chroma, video), 5)
            ms["am_add"] = cuda_ms(lambda: synth.am_add(*am_args), 5)
        del add, z, chroma, video, rendered, kern, kz, am, am_args, ai, aq
    diff = {name: int(np.count_nonzero(a != b)) for name, a, b in zip(
        ("carrier", "z", "render", "kernel", "kernel_z", "am_i", "am_q"),
        res["cuda"], res["cpu"])}
    phase("secam", rows=res["cpu"][0].shape[0], width=res["cpu"][0].shape[1],
          card_vs_cpu_differing=json.dumps(diff).replace(" ", ""),
          **{f"{k}_ms": f"{v:.3f}" for k, v in ms.items()},
          block_meta_s=f"{meta_s:.3f}", card=json.dumps(CARD["smi"]))
    if any(diff.values()):
        fail("secam: the card differs from the CPU path")
    del res
    torch.cuda.empty_cache()


def resample_phase() -> None:
    """The video resampler at the 64-frame block's shapes, on the card and
    on the CPU from the same seeded composite: byte-equal required; then
    its card time (CUDA events), its peak card memory and its bound: the
    bytes it must move (the f32 stream in, the f32 stream out) over the
    card's memory rate."""
    from hacktv_tpu_torch.ops import resampler as rs_mod
    from hacktv_tpu_torch.video.params import VideoParams
    from hacktv_tpu_torch.config import get_mode
    for mode, rate, px in (("i", 16_000_000, 14_750_000),
                           ("pal", 8_000_000, 16_000_000)):
        conf = get_mode(mode)
        p = VideoParams.create(conf, rate, px)
        wout = VideoParams.create(conf, rate, 0).width
        nlines = FPB * conf.lines
        st = rs_mod.make_block_statics(rs_mod.Resampler.create(rate, px),
                                       p.width, wout, nlines)
        rng = np.random.default_rng(21)
        flat = (rng.standard_normal((nlines + 2) * p.width) * 12000).astype(
            np.float32)
        x = torch.as_tensor(flat, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = rs_mod.device_resample_block(st, x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ref = rs_mod.device_resample_block(st, torch.as_tensor(flat))
        diff = int(np.count_nonzero(got.cpu().numpy() != ref.numpy()))
        ms = cuda_ms(lambda: rs_mod.device_resample_block(st, x), 5)
        nbytes = 4 * (x.numel() + st.n_out)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        phase("resample", mode=mode, L=st.rs.L, M=st.rs.M, A=st.rs.A,
              stride=st.stride, branch=("row" if st.rs.A <= st.stride
                                        else "per-tap"),
              inputs=x.numel(), outputs=st.n_out, card_vs_cpu_differing=diff,
              ms=f"{ms:.3f}", peak_mem_gb=f"{peak / 1e9:.3f}",
              bound_ms=f"{bound_ms:.4f}", bound_by="bytes",
              bound_share=f"{bound_ms / ms:.3f}",
              card=json.dumps(CARD["smi"]))
        if diff:
            fail(f"resample {mode}: the card differs from the CPU path")
        del x, got, ref
        torch.cuda.empty_cache()


def vbi_phase() -> None:
    """The VBI services at the 64-frame block's shapes, on the e2e paths'
    encoders (the card's and the CPU's, their host state advanced
    together): each service's host block_arrays per block (median of
    blocks 1-3), its apply on the card (CUDA events) against the same call
    on the CPU on a seeded block and the line carrier, chained in the
    registration order as the step chains them: byte-equal required.
    Then teletext's render (bits @ basis) on the card against its bound,
    the larger of 2 * lines * 360 * W FLOP over the f32 peak and its bytes
    (bits and basis read once, the f32 lines written once) over the memory
    rate; and the render with TF32 on against the CPU, with the count of
    values a plain f32 matmul under TF32 would get wrong."""
    from hacktv_tpu_torch.transfer import arrays_to_device
    from hacktv_tpu_torch.video import raster
    for path in ("pal-i-teletext-vsb", "m-cc608-acp", "i-sis"):
        spec = PATHS[path]
        g = build(spec, "cuda", noise_source(spec), FPB)
        c = build(spec, "cpu", noise_source(spec), FPB)
        nl = FPB * g.params.lines
        n = nl + 1 + g.halo_after
        W = g.params.width
        host_s = {type(svc).__name__: [] for svc in g.services}
        for b in range(1, 4):
            cg, cc = np.zeros(n, bool), np.zeros(n, bool)
            arrs = []
            for sg, sc in zip(g.services, c.services):
                t = time.perf_counter()
                ag = sg.block_arrays(b * nl - 1, n, cg)
                host_s[type(sg).__name__].append(time.perf_counter() - t)
                arrs.append((ag, sc.block_arrays(b * nl - 1, n, cc)))
        rng = np.random.default_rng(31)
        video = rng.integers(-12000, 24000, (n, W)).astype(np.float32)
        mg, mc = g._block_meta(3), c._block_meta(3)
        lut_g = raster.carrier_lut(g.dstatics, mg["cos0"], mg["sin0"],
                                   mg["lut_row"])
        lut_c = raster.carrier_lut(c.dstatics, mc["cos0"], mc["sin0"],
                                   mc["lut_row"])
        out_g, out_c = torch.as_tensor(video, device="cuda"), \
            torch.as_tensor(video)
        for sg, sc, (ag, ac) in zip(g.services, c.services, arrs):
            name = type(sg).__name__
            dg = arrays_to_device(ag, "cuda")
            rg = sg.apply(out_g, dg, lut_g)
            rc = sc.apply(out_c, arrays_to_device(ac, "cpu"), lut_c)
            diff = int(np.count_nonzero(rg.cpu().numpy() != rc.numpy()))
            ms = cuda_ms(lambda: sg.apply(out_g, dg, lut_g), 5)
            host_ms = statistics.median(host_s[name]) * 1e3
            phase("vbi", path=path, service=name, lines=n, width=W,
                  block_arrays_ms=f"{host_ms:.3f}",
                  apply_ms=f"{ms:.3f}", card_vs_cpu_differing=diff,
                  card=json.dumps(CARD["smi"]))
            if diff:
                fail(f"vbi {path} {name}: the card differs from the CPU")
            if name == "Teletext":
                render_phase(sg, dg["packed"], n, W)
            out_g, out_c = rg, rc
        del g, c, out_g, out_c, rg, rc
        torch.cuda.empty_cache()
        if path == "i-sis":
            sis_coder_phase(spec)


def sis_coder_phase(spec) -> None:
    """SiS's NICAM frame coder, the native runtime's against the numpy
    one, on the host: two i-sis encoders on the same seeded sound, one
    with each coder, SiS's block_arrays at the 64-frame block (block 0
    untimed, then blocks 1-4 in turns, median), and both coders alone on
    the same 2,560 frames of that sound (about one block's, median of 5):
    byte-equal required."""
    from hacktv_tpu_torch.audio import nicam
    encs = {}
    for native in (True, False):
        e = build(spec, "cuda", noise_source(spec), FPB)
        e.services[0].native = native
        encs[native] = e
    nl = FPB * encs[True].params.lines
    n = nl + 1 + encs[True].halo_after
    host_s = {True: [], False: []}
    differing = 0
    for b in range(5):
        got = {}
        for native, e in encs.items():
            t = time.perf_counter()
            got[native] = e.services[0].block_arrays(b * nl - 1, n,
                                                     np.zeros(n, bool))
            if b:
                host_s[native].append(time.perf_counter() - t)
        differing += int(np.count_nonzero(got[True]["syms"]
                                          != got[False]["syms"]))
    frames = 2560
    chain = encs[True].services[0].state.chain
    pcm = np.concatenate([np.zeros((nicam.J17_NTAPS - 1, 2), np.int64),
                          chain._pcm(0, 32 * frames)])
    coder_s, out = {True: [], False: []}, {}
    for _ in range(5):
        for native in (True, False):
            t = time.perf_counter()
            out[native] = nicam.encode_frames(pcm, 0, nicam.MODE_STEREO, 0,
                                              native=native)
            coder_s[native].append(time.perf_counter() - t)
    frame_diff = int(np.count_nonzero(out[True] != out[False]))
    med = lambda v: f"{statistics.median(v) * 1e3:.3f}"
    phase("sis-coder", block_arrays_native_ms=med(host_s[True]),
          block_arrays_numpy_ms=med(host_s[False]),
          symbols_differing=differing, frames=frames,
          coder_native_ms=med(coder_s[True]),
          coder_numpy_ms=med(coder_s[False]),
          frame_bytes_differing=frame_diff, card=json.dumps(CARD["smi"]))
    if differing or frame_diff or out[True].shape != (frames, 91):
        fail("sis-coder: the native NICAM coder differs from numpy's")
    del encs
    torch.cuda.empty_cache()


def render_phase(svc, packed, n: int, W: int) -> None:
    """Teletext's render at the block's shape: its card time against its
    bound, and exactness with TF32 on."""
    from hacktv_tpu_torch.services import vbidata
    bits = vbidata.device_unpack_bits(packed, 360)
    basis = svc.d_basis
    ms = cuda_ms(lambda: vbidata.render(bits, basis), 5)
    flops = 2 * n * 360 * W
    nbytes = 4 * (n * 360 + 360 * W + n * W)
    t_ops = flops / F32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    ref = vbidata.render(bits.cpu(), basis.cpu())
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = vbidata.render(bits, basis).cpu()
        plain = torch.matmul(bits, basis).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    diff = int((tf32 != ref).sum())
    phase("vbi-render", service="Teletext", lines=n, width=W,
          packets=int((packed[:, 0] != 0).sum()), ms=f"{ms:.4f}",
          bound_ms=f"{bound_ms:.4f}",
          bound_by="operations" if t_ops >= t_bytes else "bytes",
          bound_share=f"{bound_ms / ms:.3f}", flop=flops, bytes=nbytes,
          tf32_on_differing=diff,
          f32_matmul_under_tf32_differing=int((plain != ref).sum()),
          card=json.dumps(CARD["smi"]))
    if diff:
        fail("vbi render: TF32 changed the card's result")


def scramble_phase() -> None:
    """The scramblers at the 64-frame block's shapes, on the encoders of
    SCRAMBLE_PATHS (the card's and the CPU's, their host state advanced
    together): each one's host block_arrays per block (median of blocks
    1-3), its apply on the card (CUDA events) against the same call on
    the CPU on a seeded block with the service's halo: byte-equal
    required."""
    from hacktv_tpu_torch.transfer import arrays_to_device
    for path in SCRAMBLE_PATHS:
        spec = CPU_PATHS[path]
        g = build(spec, "cuda", noise_source(spec), FPB)
        c = build(spec, "cpu", noise_source(spec), FPB)
        nl = FPB * g.params.lines
        n = nl + 1 + g.halo_after
        W = g.params.width
        host_s = {type(svc).__name__: [] for svc in g.services}
        for b in range(1, 4):
            cg, cc = np.zeros(n, bool), np.zeros(n, bool)
            arrs = []
            for sg, sc in zip(g.services, c.services):
                t = time.perf_counter()
                ag = sg.block_arrays(b * nl - 1, n, cg)
                host_s[type(sg).__name__].append(time.perf_counter() - t)
                arrs.append((ag, sc.block_arrays(b * nl - 1, n, cc)))
        video = np.random.default_rng(41).integers(
            -12000, 24000, (n, W)).astype(np.float32)
        out_g, out_c = torch.as_tensor(video, device="cuda"), \
            torch.as_tensor(video)
        for sg, sc, (ag, ac) in zip(g.services, c.services, arrs):
            name = type(sg).__name__
            dg = arrays_to_device(ag, "cuda")
            rg = sg.apply(out_g, dg)
            rc = sc.apply(out_c, arrays_to_device(ac, "cpu"))
            diff = int(np.count_nonzero(rg.cpu().numpy() != rc.numpy()))
            ms = cuda_ms(lambda: sg.apply(out_g, dg), 5)
            phase("scramble", path=path, service=name, lines=n, width=W,
                  block_arrays_ms=f"{statistics.median(host_s[name]) * 1e3:.3f}",
                  apply_ms=f"{ms:.3f}", card_vs_cpu_differing=diff,
                  card=json.dumps(CARD["smi"]))
            if diff:
                fail(f"scramble {path} {name}: the card differs from the CPU")
            out_g, out_c = rg, rc
        del g, c, out_g, out_c, rg, rc
        torch.cuda.empty_cache()


def dance_phase() -> None:
    """ntsc-bs's DANCE at the 64-frame block's shapes: the host coder
    (dance_block: the PCM calls, pre-emphasis, frames and differential
    signs) per block (median of blocks 0-3), and the two-part pulse
    product (nicam_add of those signs) on the card against the CPU, with
    TF32 off and on: byte-equal required; its card time (CUDA events)."""
    from hacktv_tpu_torch.audio import synth
    spec = PATHS["ntsc-bs"]
    encs = {d: build(spec, d, noise_source(spec), FPB)
            for d in ("cuda", "cpu")}
    e = encs["cpu"]
    nl = FPB * e.params.lines
    host = []
    for b in range(4):
        t = time.perf_counter()
        dc = e.audio.dance_block(b * nl, nl, e.dance_statics)
        host.append(time.perf_counter() - t)
    res, ms = {}, None
    was = torch.backends.cuda.matmul.allow_tf32
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            for d, enc in encs.items():
                zero = torch.zeros((nl, enc.params.width), device=d)
                args = (enc.dance_statics, zero, zero,
                        torch.as_tensor(dc["signs_i"], device=d),
                        torch.as_tensor(dc["signs_q"], device=d), dc["offq"],
                        dc["offr"], torch.as_tensor(dc["cc_off"], device=d),
                        (3 * nl) % enc.dance_statics.period)
                res[(d, tf32)] = [t.cpu() for t in synth.nicam_add(*args)]
                if d == "cuda" and not tf32:
                    ms = cuda_ms(lambda: synth.nicam_add(*args), 5)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
    diff = {f"tf32_{'on' if tf32 else 'off'}": sum(
        int((a != b).sum()) for a, b in zip(res[("cuda", tf32)],
                                            res[("cpu", tf32)]))
        for tf32 in (False, True)}
    st = e.dance_statics
    phase("dance", lines=nl, width=e.params.width, period=st.period,
          nslot=st.nslot, max_tap=int(st.pulse.abs().max()),
          dance_block_ms=f"{statistics.median(host) * 1e3:.1f}",
          nicam_add_ms=f"{ms:.3f}",
          card_vs_cpu_differing=json.dumps(diff).replace(" ", ""),
          card=json.dumps(CARD["smi"]))
    if any(diff.values()):
        fail("dance: the card's pulse product differs from the CPU's")
    del encs, res
    torch.cuda.empty_cache()


def mac_phase() -> None:
    """Each MAC path at the 64-frame block's shapes: the host multiplex
    and upload buffer (_prepare_host) per block (median of blocks 1-3),
    the card step (_step_impl_dev on block 3's buffer) and, each alone
    on the inputs the step gave them, the three duobinary products, the
    cut gather and FM (CUDA events); the step's peak card memory.  The
    (f64) products on the card with TF32 off and on against the CPU:
    byte-equal required; beside them the count of values that f32
    products under TF32 get wrong.  Their bound: the larger of the bytes
    (symbols and bases read once, the two sums written once, all f64)
    over the memory rate and the banded FLOP (2 per nonzero basis tap
    and row) over the f64 peak, which on an H100 SXM is the f32 one."""
    from hacktv_tpu_torch.rf import ops as rf_ops
    from hacktv_tpu_torch.video import mac as mac_mod
    for path in MAC_PATHS:
        g, _, _ = make_path(path, "cuda", FPB)
        host = []
        for b in range(4):
            t = time.perf_counter()
            prep = g._prepare_host(b)
            host.append(time.perf_counter() - t)
        seen = {}

        def keep(name, fn):
            def wrapped(*a):
                seen[name] = a
                out = fn(*a)
                seen[name + "_out"] = out
                return out
            return wrapped
        g.symbols = keep("symbols", g.symbols)
        g.cut = keep("cut", g.cut)
        buf = torch.as_tensor(prep[1]).to("cuda")
        planes, meta = g._device_planes(3 * FPB), g._line_meta()
        pol = g._pol_c[0]
        fm_r0 = torch.zeros((), dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        g._step_impl_dev(buf, pol, planes, meta, fm_r0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del g.symbols, g.cut
        sym = seen["symbols_out"]
        canvas, scr, xc1, xc2 = seen["cut"]
        step_ms = cuda_ms(
            lambda: g._step_impl_dev(buf, pol, planes, meta, fm_r0), 5)
        prod_ms = cuda_ms(lambda: g.products(sym), 5)
        cut_ms = (cuda_ms(lambda: g.cut(canvas, scr, xc1, xc2), 5)
                  if not g.vsam & 1 else None)
        fm_ms = (cuda_ms(lambda: rf_ops.fm_video_modulate(
            g.fm_video_statics, seen["cut_out"], fm_r0), 5)
            if g.fm_video_statics is not None else None)
        # exactness: card (TF32 off, on) against the CPU
        ref = mac_mod.duobinary_products(
            tuple(b.cpu() for b in g.d_bases), sym.cpu())
        diff, f32_wrong = {}, 0
        was = torch.backends.cuda.matmul.allow_tf32
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                got = [t.cpu() for t in g.products(sym)]
                if tf32:
                    nrows = sym.shape[0] - 2
                    B = [torch.as_tensor(a, device="cuda")
                         for a in (g.Bm, g.B0, g.Bp)]
                    s32 = sym.float()
                    plain = (s32[1:nrows + 1] @ B[1] + s32[0:nrows] @ B[2],
                             s32[2:nrows + 2] @ B[0])
                    f32_wrong = sum(int((a.cpu() != b).sum())
                                    for a, b in zip(plain, ref))
                    del B, s32, plain
            finally:
                torch.backends.cuda.matmul.allow_tf32 = was
            diff[f"tf32_{'on' if tf32 else 'off'}"] = sum(
                int((a != b).sum()) for a, b in zip(got, ref))
        rows, nbits = sym.shape
        W = g.width
        n = rows - 2
        nnz = sum(int(np.count_nonzero(a)) for a in (g.Bm, g.B0, g.Bp))
        nbytes = 8 * (rows * nbits + 3 * nbits * W + 2 * n * W)
        flop = 2 * n * nnz
        dense_flop = 3 * 2 * n * nbits * W
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flop / F64_FLOP_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        phase("mac", path=path, rows=rows, nbits=nbits, width=W,
              prepare_host_ms=f"{statistics.median(host[1:]) * 1e3:.2f}",
              step_ms=f"{step_ms:.3f}", products_ms=f"{prod_ms:.3f}",
              cut_ms="-" if cut_ms is None else f"{cut_ms:.3f}",
              fm_ms="-" if fm_ms is None else f"{fm_ms:.3f}",
              products_bound_ms=f"{bound_ms:.4f}",
              products_bound_by="bytes" if t_bytes >= t_ops else
              "operations",
              products_bound_share=f"{bound_ms / prod_ms:.3f}",
              products_bytes=nbytes, products_banded_flop=flop,
              products_dense_flop=dense_flop,
              max_basis=int(max(np.abs(a).max()
                                for a in (g.Bm, g.B0, g.Bp))),
              card_vs_cpu_differing=json.dumps(diff).replace(" ", ""),
              f32_under_tf32_differing=f32_wrong,
              step_peak_mem_gb=f"{peak / 1e9:.3f}",
              card=json.dumps(CARD["smi"]))
        if any(diff.values()):
            fail(f"mac {path}: the card's products differ from the CPU's")
        del g, seen, sym, canvas, buf, ref
        torch.cuda.empty_cache()


def e2e_phase(path: str, profile_dir) -> dict:
    enc, rate, vfilter = make_path(path, "cuda", FPB)
    # FM video on the host finishes in collect_block (its FM recurrence):
    # there a block is timed to the end of its collection
    host_fm = getattr(enc, "fm_video_exact", None) is not None
    torch.cuda.reset_peak_memory_stats()
    since = fir_launches()
    for b in range(WARM_BLOCKS):
        out = enc.encode_block_device(b)
        if host_fm:
            host = enc.collect_block(b, out)
    torch.cuda.synchronize()
    block_s, enqueue_s, collect_s = [], [], []
    t0 = time.perf_counter()
    for b in range(WARM_BLOCKS, WARM_BLOCKS + TIMED_BLOCKS):
        tb = time.perf_counter()
        out = enc.encode_block_device(b)
        # the host's share: the block is issued, the card may still run
        enqueue_s.append(time.perf_counter() - tb)
        torch.cuda.synchronize()
        if host_fm:
            tc = time.perf_counter()
            host = enc.collect_block(b, out)
            collect_s.append(time.perf_counter() - tc)
        block_s.append(time.perf_counter() - tb)
    dt = time.perf_counter() - t0
    launches = fir_launches(since)
    nblocks = WARM_BLOCKS + TIMED_BLOCKS
    samples = TIMED_BLOCKS * FPB * enc.frame_samples
    if not host_fm:
        host = enc.collect_block(WARM_BLOCKS + TIMED_BLOCKS - 1, out)
    if not np.isfinite(host.astype(np.float64)).all() or host.size != (
            FPB * enc.frame_samples * (2 if enc.complex_out else 1)):
        fail(f"{path}: output of the wrong size")
    if np.abs(host.astype(np.int64)).max() == 0:
        fail(f"{path}: output is all zero")
    phase("e2e", path=path, card=json.dumps(CARD["smi"]), blocks=nblocks,
          samples_per_s=f"{samples/dt:.0f}",
          x_realtime=f"{samples / dt / rate:.2f}",
          block_s=",".join(f"{s:.4f}" for s in block_s),
          median_block_s=f"{statistics.median(block_s):.4f}",
          median_enqueue_s=f"{statistics.median(enqueue_s):.4f}",
          median_collect_s=(f"{statistics.median(collect_s):.4f}"
                            if collect_s else "-"),
          launches=json.dumps(launches).replace(" ", ""),
          peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    # S-Video runs the low-pass on the C channel too
    want = ({} if not vfilter else
            {"fir_cplx": nblocks} if enc.vf_taps[1] is not None else
            {"fir_real": nblocks * (2 if enc.conf.s_video else 1)})
    for k, v in launches.items():
        if v != want.get(k, 0):
            fail(f"{path}: {k} launched {v} times for {nblocks} blocks")
    if host_fm:
        fm_host_phase(enc, out)
    if path in BUSY_PATHS:
        busy_phase(enc, path, nblocks, statistics.median(block_s))
    elif profile_dir:
        profile_block(enc, WARM_BLOCKS + TIMED_BLOCKS, path, profile_dir)
    if path in MOVING_PATHS:
        moving_host_phase(enc)
    del enc, out, host
    torch.cuda.empty_cache()
    return launches


def bench_phase() -> None:
    """The port's measurement entry points at their defaults, each JSON
    line printed as the entry point prints it; i --e2e file's sink kept
    and its first two blocks held against a second encoder's."""
    from hacktv_tpu_torch import bench
    from hacktv_tpu_torch.tools import profile_bench, service_bench
    t = time.perf_counter()
    show = lambda line: print(json.dumps(line), flush=True)
    with tempfile.TemporaryDirectory() as d:
        sink = os.path.join(d, "i-e2e-file.bin")
        for name, e2e in bench.ALL_RUNS:
            keep = sink if e2e == "file" else None
            show(bench.bench_config(name, e2e, sink_path=keep))
            if keep:
                bench_sink_check(bench, name, keep)
                os.remove(keep)
    show(bench.bench_config("mux2"))
    show(bench.bench_config("i", dynamic=True))
    show(bench.d2h_bandwidth())
    for label, (mode, rate, kw) in service_bench.CONFIGS.items():
        show(service_bench.bench_one(label, mode, rate, kw))
    show(profile_bench.profile()[0])
    mac_pipeline_check(bench)
    bench_sync_check(bench)
    bench_e2e_split(bench)
    phase("bench", seconds=f"{time.perf_counter() - t:.1f}")


def bench_sync_check(bench) -> None:
    """Where the host waits for the card inside a block of each bench
    configuration: block 2 (after blocks 0-1, each waited for) under
    torch's sync debug mode, which warns at each synchronising call (a
    copy between the card and pageable host memory, .item(), ...): the
    count and the source lines that made them."""
    for name in bench._CONFIGS:
        enc = bench.make_encoder(name)
        for b in range(2):
            bench.wait(enc.encode_block_device(b))
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = enc.encode_block_device(2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        bench.wait(out)
        bench.stop_mux_worker(enc)
        sites = collections.Counter(
            f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in ws
            if "synchroniz" in str(w.message))
        phase("bench-syncs", config=name, syncs=sum(sites.values()),
              sites=",".join(f"{k}x{n}" for k, n in sites.most_common(8)))
        del enc, out


def bench_e2e_split(bench) -> None:
    """bench's i --e2e null block by its parts, blocks 2-5 of a stream
    with the one-block lag: the dispatch of block b (encode_block_device),
    the collection of b - 1 (its wait and copy back) and the sink's
    write; median ms of each."""
    from hacktv_tpu_torch import runtime
    enc = bench.make_encoder("i")
    sink = runtime.NativeFileSink(os.devnull, "int16", enc.complex_out)
    ms = {"enqueue": [], "collect": [], "write": []}
    prev = None
    for b in range(6):
        t0 = time.perf_counter()
        out = enc.encode_block_device(b)
        t1 = time.perf_counter()
        if prev is not None:
            host = enc.collect_block(b - 1, prev)
            t2 = time.perf_counter()
            sink.write(host)
            t3 = time.perf_counter()
            if b >= 2:
                for k, dt in zip(ms, (t1 - t0, t2 - t1, t3 - t2)):
                    ms[k].append(dt * 1e3)
        prev = out
    sink.close()
    phase("bench-e2e-split", config="i", e2e="null", blocks="2-5",
          **{f"{k}_ms": f"{statistics.median(v):.2f}" for k, v in ms.items()})


def mac_pipeline_check(bench) -> None:
    """bench's dmac (dmac-fm, 32-frame blocks) with its multiplex on the
    main thread and on the pipeline's worker (pipeline_mux), in turns
    off, on, on, off: the median trial's ms a block, timed as bench
    times a stream."""
    from hacktv_tpu_torch.config import get_mode
    from hacktv_tpu_torch.video.mac import MacEncoder
    ms = {False: [], True: []}
    for pipe in (False, True, True, False):
        enc = MacEncoder(get_mode("dmac-fm"), 20_250_000, 0,
                         frames_per_block=32, pipeline_mux=pipe)
        trial_s = bench.stream_trials(enc.encode_block_device)
        bench.stop_mux_worker(enc)
        ms[pipe].append(statistics.median(trial_s) / 8 * 1e3)
        del enc
    phase("mac-pipeline", config="dmac", frames_per_block=32,
          off_ms=",".join(f"{x:.2f}" for x in ms[False]),
          on_ms=",".join(f"{x:.2f}" for x in ms[True]))


def bench_sink_check(bench, name: str, path: str) -> None:
    """The sink file's blocks 0-1 equal a second encoder's collect_block
    of blocks 0-1 on the card."""
    enc = bench.make_encoder(name)
    n = enc.frames_per_block * enc.frame_samples
    got = np.fromfile(path, np.int16, count=4 * n).reshape(-1, 2)
    for b in range(2):
        want = enc.collect_block(b, enc.encode_block_device(b))
        if not np.array_equal(got[b * n:(b + 1) * n], want):
            fail(f"bench {name} --e2e file: block {b} of the sink differs "
                 "from collect_block")
    phase("bench-sink", config=name, blocks="0-1", samples=2 * n,
          differing=0)


def busy_phase(enc, path: str, b: int, block_s: float) -> None:
    """The card's busy and idle share of a block, and the card step
    alone.  Block b under torch.profiler: the summed time of its device
    activities (kernels and copies) against the median timed block, idle
    = 1 - device / block; then block b + 1's step (_step) with its host
    arguments prepared beforehand, by CUDA events: the card's work
    without the host's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        enc.encode_block_device(b)
        torch.cuda.synchronize()
    dev = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    device_ms = sum(dev) / 1e3
    yuv = enc._device_rgb(b + 1)
    m = enc._block_meta(b + 1)
    args = enc._audio_args(b + 1)
    step_ms = cuda_ms(lambda: enc._step(yuv, m, 1.0, args), 3)
    phase("busy", path=path, device_ms=f"{device_ms:.2f}",
          device_activities=len(dev), median_block_ms=f"{block_s * 1e3:.1f}",
          idle_share=(f"{1 - device_ms / (block_s * 1e3):.3f}" if dev
                      else "not measured"),
          step_ms=f"{step_ms:.2f}", card=json.dumps(CARD["smi"]))


def moving_host_phase(enc) -> None:
    """The moving path's own parts: the LUT's build on the host and its
    upload; one frame's read and fit (RawFileSource + FitSource, the
    median over 33 frames); the stack of a block's 66 frames and its
    upload; the card's conversion of that stack, and its gather alone
    with int32 and with int64 indices (CUDA events)."""
    from hacktv_tpu_torch.video import raster
    p = enc.params
    t = time.perf_counter()
    lut = raster.make_yuv_lut(p)
    lut_s = time.perf_counter() - t
    t = time.perf_counter()
    d_lut = torch.as_tensor(lut, device="cuda")
    torch.cuda.synchronize()
    lut_up_s = time.perf_counter() - t
    src = motion_source("i", 16_000_000)
    frame_s, frames = [], []
    for f in range(enc._nf):
        t = time.perf_counter()
        frames.append(np.array(src.read_video(f), copy=True))
        frame_s.append(time.perf_counter() - t)
    src.close()
    t = time.perf_counter()
    stack = np.stack(frames)
    stack_s = time.perf_counter() - t
    t = time.perf_counter()
    d_stack = torch.as_tensor(stack, device="cuda")
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t

    def index(rgb, dtype):
        c = rgb.to(dtype)
        return ((c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]).reshape(-1)
    idx32, idx64 = index(d_stack, torch.int32), index(d_stack, torch.int64)
    g32 = cuda_ms(lambda: torch.index_select(d_lut, 0, idx32), 5)
    g64 = cuda_ms(lambda: torch.index_select(d_lut, 0, idx64), 5)
    conv = cuda_ms(lambda: raster.yuv_convert_device(d_lut, d_stack), 5)
    phase("moving-host", frames=len(frames), pixels=int(idx32.numel()),
          lut_build_s=f"{lut_s:.3f}", lut_upload_s=f"{lut_up_s:.3f}",
          read_fit_ms_per_frame=f"{statistics.median(frame_s) * 1e3:.2f}",
          stack_ms=f"{stack_s * 1e3:.1f}", upload_ms=f"{up_s * 1e3:.1f}",
          upload_gb_per_s=f"{stack.nbytes / up_s / 1e9:.2f}",
          gather_int32_ms=f"{g32:.3f}", gather_int64_ms=f"{g64:.3f}",
          convert_ms=f"{conv:.3f}", card=json.dumps(CARD["smi"]))
    del d_lut, d_stack, idx32, idx64
    torch.cuda.empty_cache()


def moving_phase() -> None:
    """The moving file on the card: the LUT gather of one block's 66-frame
    stack against the host conversion (rgb_to_yuv_host); i-moving-vsb at
    MOVING_FPB frames a block against one frame a block, blocks 0-1; each
    of MOVING_CPU_PATHS and D2-MAC FM (two-frame blocks) card against
    the port's CPU path, blocks 0-3: 0 differing values required."""
    from hacktv_tpu_torch.video import raster
    from hacktv_tpu_torch.video.params import VideoParams
    from hacktv_tpu_torch.config import get_mode
    p = VideoParams.create(get_mode("i"), 16_000_000)
    src = motion_source("i", 16_000_000)
    stack = np.stack([np.array(src.read_video(f)) for f in range(FPB + 2)])
    src.close()
    lut = torch.as_tensor(raster.build_yuv_lut(p), device="cuda")
    got = [a.cpu().numpy() for a in raster.yuv_convert_device(
        lut, torch.as_tensor(stack, device="cuda"))]
    diff = 0
    for f0 in range(0, len(stack), 6):
        ref = raster.rgb_to_yuv_host(p, stack[f0:f0 + 6])
        diff += sum(int(np.count_nonzero(g[f0:f0 + 6] != r))
                    for g, r in zip(got, ref))
    phase("moving", check="lut-gather", frames=len(stack),
          values=3 * stack[..., 0].size, differing=diff)
    if diff:
        fail("moving: the LUT gather differs from the host conversion")
    del lut, got
    torch.cuda.empty_cache()

    spec = MOVING_PATHS["i-moving-vsb"]
    enc4 = build(spec, "cuda", motion_source("i", 16_000_000), MOVING_FPB)
    enc1 = build(spec, "cuda", motion_source("i", 16_000_000), 1)
    a = np.concatenate([enc4.encode_block(b).reshape(-1) for b in range(2)])
    r = np.concatenate([enc1.encode_block(b).reshape(-1)
                        for b in range(2 * MOVING_FPB)])
    nd = int(np.count_nonzero(a != r)) if a.shape == r.shape else -1
    phase("moving", check=f"i-moving-vsb fpb={MOVING_FPB} vs fpb=1",
          blocks=2, differing=nd, of=a.size)
    if nd:
        fail("moving: multi-frame blocks differ from one-frame blocks")
    del enc4, enc1

    cases = [(name, lambda d, s=spec: build(
        s, d, motion_source(s[0], s[1], s[3].get("pixel_rate", 0)),
        MOVING_FPB)) for name, spec in MOVING_CPU_PATHS.items()]
    mspec = ("d2mac-fm", MAC_RATE, {})
    cases.append(("d2mac-fm-moving-2f", lambda d: build_mac(
        mspec, d, motion_source("d2mac-fm", MAC_RATE), 2)))
    for name, make in cases:
        g, c = make("cuda"), make("cpu")
        for b in range(CPU_BLOCKS):
            x = g.encode_block(b).astype(np.int64)
            y = c.encode_block(b).astype(np.int64)
            if x.shape != y.shape:
                fail(f"moving {name} block {b}: shape {x.shape} != {y.shape}")
            nd = int(np.count_nonzero(x != y))
            phase("card-vs-cpu", path=f"moving-{name}", block=b,
                  max_err=int(np.abs(x - y).max()), differing=nd, of=x.size)
            if nd:
                fail(f"moving {name} block {b}: card and CPU differ")
        del g, c
        torch.cuda.empty_cache()


def checkpoint_phase() -> None:
    """Each of CHECKPOINT_PATHS at MOVING_FPB frames a block: blocks 0-3
    continuous on the card; a checkpoint at block 2 on the card, resumed
    in a fresh card encoder and in a fresh CPU encoder: blocks 2-3 of both
    equal the continuous run (0 differing samples required)."""
    for path in CHECKPOINT_PATHS:
        full = make_path(path, "cuda", MOVING_FPB)[0]
        ref = [full.encode_block(b) for b in range(4)]
        a = make_path(path, "cuda", MOVING_FPB)[0]
        for b in range(2):
            a.encode_block(b)
        blob = a.checkpoint(2)
        del full, a
        for dev in ("cuda", "cpu"):
            r = make_path(path, dev, MOVING_FPB)[0]
            if r.load_checkpoint(blob) != 2:
                fail(f"checkpoint {path}: resumed at the wrong block")
            nd = sum(int(np.count_nonzero(r.encode_block(b) != ref[b]))
                     for b in (2, 3))
            phase("checkpoint", path=path, resumed_on=dev, blocks="2-3",
                  bytes=len(blob), differing=nd)
            if nd:
                fail(f"checkpoint {path}: the resumed stream on {dev} "
                     "differs")
            del r
        torch.cuda.empty_cache()


def shard_kernel_check(sf, fn, taps, n: int) -> int:
    """A kernel at a shard's shape against its plain version, on a
    stream laid out as the encoder's (a halo line before, half a filter
    before the shard's lines): the count of differing outputs.  These
    launches are the check's, not a path's: they come after the path's
    counts are read."""
    nt = taps[0].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(n + nt + 2048, generator=gen, device="cuda") * 8000.0
    xs = x[1024 - nt // 2: 1024 - nt // 2 + n + nt - 1]
    got = fn(xs, *taps, n)
    plain = sf.stream_fir_plain(xs, taps[0],
                                taps[1] if len(taps) > 1 else None, n)
    got = got if isinstance(got, tuple) else (got,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    return sum(int((a != b).sum()) for a, b in zip(got, plain))


def sharded_run(enc, ref: list, name: str, timed: int,
                first_timed: int = 0) -> dict:
    """Blocks 0-3 of a sharded encoder against `ref` (one device's), then
    `timed` more blocks from block `first_timed` (default: the one after
    them), timed: median block and enqueue ms, each shard's row stage on
    the card (CUDA events, the last block), peak card memory, launches."""
    torch.cuda.reset_peak_memory_stats()
    since = fir_launches()
    nd = 0
    for b, r in enumerate(ref):
        got = enc.encode_block(b)
        if got.shape != r.shape:
            fail(f"devices {name} block {b}: shape {got.shape} != "
                 f"{r.shape}")
        nd += int(np.count_nonzero(got != r))
    if nd:
        fail(f"devices {name}: {nd} samples of blocks 0-3 differ from one "
             "device")
    block_s, enqueue_s = [0.0], [0.0]
    b0 = first_timed or len(ref)
    for b in range(b0, b0 + timed):
        enc.shard_timing = b == b0 + timed - 1
        torch.cuda.synchronize()
        tb = time.perf_counter()
        enc.encode_block_device(b)
        enqueue_s.append(time.perf_counter() - tb)
        torch.cuda.synchronize()
        block_s.append(time.perf_counter() - tb)
    if timed:
        block_s, enqueue_s = block_s[1:], enqueue_s[1:]
    shard_ms = [ev0.elapsed_time(ev1) for _, ev0, ev1 in enc.shard_events]
    nblocks = len(ref) + timed
    return dict(differing=nd, blocks=nblocks,
                median_block_ms=statistics.median(block_s) * 1e3,
                median_enqueue_ms=statistics.median(enqueue_s) * 1e3,
                shard_ms=shard_ms,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=fir_launches(since))


def card_runs(ncards: int) -> list:
    """The device lists across cards: 2 cards, and 4 where there are."""
    return [[f"cuda:{k}" for k in range(n)] for n in (2, 4) if n <= ncards]


def full_width_runs(sf, runs: list, counts: dict) -> None:
    """pal-i-vsb at FPB frames a block (40,000 lines) on one device, then
    on each device list of `runs`: blocks 0-3 byte-identical to one
    device, the block times, and fir_cplx at the shards' shape against
    its plain version; its launches go into `counts`."""
    path = "pal-i-vsb"
    spec = PATHS[path]
    one = build(spec, "cuda", noise_source(spec), FPB)
    ref = [one.encode_block(b) for b in range(4)]
    base = sharded_run(one, [], "one device", DEVICE_TIMED,
                       first_timed=len(ref))
    phase("devices", path=path, shards=1, devices="cuda:0",
          lines=FPB * 625, median_block_ms=f"{base['median_block_ms']:.2f}",
          median_enqueue_ms=f"{base['median_enqueue_ms']:.2f}",
          peak_mem_gb=f"{base['peak_mem_gb']:.2f}",
          card=json.dumps(CARD["smi"]))
    taps = one.vf_taps
    n_block = FPB * 625 * one.out_params.width
    del one
    torch.cuda.empty_cache()
    for devs in runs:
        n = len(devs)
        name = f"{path} x{n} on {','.join(sorted(set(devs)))}"
        enc = build((*spec[:3], {**spec[3], "devices": devs}), "cuda",
                    noise_source(spec), FPB)
        r = sharded_run(enc, ref, name, DEVICE_TIMED)
        per_block = r["launches"]["fir_cplx"] / r["blocks"]
        mism = shard_kernel_check(sf, sf.fir_cplx, taps, n_block // n)
        phase("devices", path=path, shards=n, devices=",".join(devs),
              lines_per_shard=FPB * 625 // n,
              blocks_0_3_differing=r["differing"],
              median_block_ms=f"{r['median_block_ms']:.2f}",
              vs_one_device="{:.3f}".format(
                  r["median_block_ms"] / base["median_block_ms"]),
              median_enqueue_ms=f"{r['median_enqueue_ms']:.2f}",
              shard_row_stage_ms=",".join(f"{t:.2f}" for t in r["shard_ms"]),
              peak_mem_gb=f"{r['peak_mem_gb']:.2f}",
              fir_cplx_per_block=f"{per_block:g}",
              fir_cplx_at_shard_shape_mismatches=mism,
              card=json.dumps(CARD["smi"]))
        if per_block != n:
            fail(f"devices {name}: fir_cplx launched {per_block} times a "
                 f"block, not {n}")
        if mism:
            fail(f"devices {name}: fir_cplx differs from its plain version "
                 "at the shard's shape")
        counts["fir_cplx"][f"{path}-x{n}"] = r["launches"]["fir_cplx"]
        del enc
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()


def devices_phase(sf) -> dict:
    """Encoder(devices=...): pal-i-vsb at FPB frames a block (40,000
    lines) in 2 and 4 shards on one card, and on the cards present when
    there are several, blocks 0-3 byte-identical to one device and its
    block times; the kernels at the shards' shapes against their plain
    versions; SHARDED_PATHS at MOVING_FPB frames a block in 2 shards,
    blocks 0-3 byte-identical to one device.  Returns each kernel's
    launches on the sharded paths."""
    counts = {"fir_cplx": {}, "fir_real": {}}
    runs = [["cuda:0"] * n for n in DEVICE_SHARDS]
    ncards = torch.cuda.device_count()
    if ncards >= 2:
        runs += card_runs(ncards)
    else:
        phase("devices-multi", cards=ncards,
              result="skipped, not failed: only one card was present, so "
                     "no speed-up across cards was measured")
    full_width_runs(sf, runs, counts)
    for path in SHARDED_PATHS:
        mac = path in MAC_PATHS
        spec = MAC_PATHS[path] if mac else CPU_PATHS[path]
        if mac:
            src = mac_noise_source(spec)
            mk = lambda devs: build_mac(
                (*spec[:2], {**spec[2], "devices": devs}), "cuda", src,
                MOVING_FPB)
        else:
            src = noise_source(spec)
            mk = lambda devs: build(
                (*spec[:3], {**spec[3], "devices": devs}), "cuda", src,
                MOVING_FPB)
        one = mk(None)
        ref = [one.encode_block(b) for b in range(4)]
        del one
        enc = mk(["cuda:0"] * 2)
        r = sharded_run(enc, ref, path, 0)
        phase("devices", path=path, shards=2, frames_per_block=MOVING_FPB,
              blocks_0_3_differing=r["differing"],
              launches=json.dumps(r["launches"]).replace(" ", ""))
        for k, v in r["launches"].items():
            if v:
                counts[k][f"{path}-x2"] = v
        if path == "pal-lowpass":
            w = enc.out_params.width
            mism = shard_kernel_check(sf, sf.fir_real, [enc.vf_taps[0]],
                                      MOVING_FPB * 625 * w // 2)
            phase("devices", path=path, check="fir_real at the shard's "
                  "shape", mismatches=mism)
            if mism or not r["launches"]["fir_real"]:
                fail(f"devices {path}: fir_real not launched or differs")
        del enc
        torch.cuda.empty_cache()
    return counts


def hosts_phase() -> None:
    """--hosts 2: two processes of the command line on the card at once
    (--host 0 and 1), each encoding its half of the blocks to a part, and
    process 0 joining them; the joined file must hold the bytes of one
    process, and no part may remain.  Each process's wall seconds."""
    env = {**os.environ, "PYTHONPATH": HERE}
    with tempfile.TemporaryDirectory() as tmp:
        single = os.path.join(tmp, "single.bin")
        multi = os.path.join(tmp, "multi.bin")
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "hacktv_tpu_torch",
                            *HOSTS_ARGS, "-o", single, "test"], cwd=tmp,
                           env=env, capture_output=True, text=True,
                           timeout=600)
        single_s = time.perf_counter() - t
        if r.returncode != 0:
            fail(f"hosts: the single process exited {r.returncode}: "
                 f"{r.stderr[-2000:]}")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "hacktv_tpu_torch", *HOSTS_ARGS,
             "--hosts", "2", "--host", str(i), "-o", multi, "test"],
            cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(2)]
        wall, outs = [], []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
                wall.append(time.perf_counter() - t0)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                fail(f"hosts: --host {i} exited {p.returncode}: "
                     f"{out[-2000:]}")
        left = sorted(f for f in os.listdir(tmp)
                      if ".part" in f or f.endswith(".done"))
        same = (os.path.exists(multi) and
                open(single, "rb").read() == open(multi, "rb").read())
        phase("hosts", args="".join(HOSTS_ARGS), hosts=2,
              single_process_s=f"{single_s:.1f}",
              host_wall_s=",".join(f"{w:.1f}" for w in wall),
              bytes=os.path.getsize(single), identical=same,
              parts_left=len(left))
        if not same or left:
            fail(f"hosts: the joined file differs or parts remain {left}")


def fm_host_phase(enc, out) -> None:
    """The host's parts of one block of FM video on the host, each timed
    alone: the sound carrier's held feed (fm_exact_stream), one serial
    carrier recurrence over the block's samples (rt_fm_carrier_exact; the
    block runs two, sound and video) and the copy of the block's int16
    (I, Q) from the card."""
    from hacktv_tpu_torch import runtime
    c = enc.audio.fm_mono
    n = FPB * enc.params.lines * enc.out_params.width
    if c is None:
        # no FM sound carrier (ntsc-bs): time the video's recurrence on a
        # block of its output's I channel
        conf = enc.conf
        feed = np.ascontiguousarray(out[..., 0].cpu().numpy()).reshape(-1)
        feed_s = 0.0
        fx = runtime.FmCarrierExact(
            0.0, conf.fm_deviation, enc.params.sample_rate,
            int(round(32767 * conf.fm_level * conf.level)))
    else:
        t = time.perf_counter()
        feed = enc.audio.fm_exact_stream(c, 0, n)
        feed_s = time.perf_counter() - t
        fx = runtime.FmCarrierExact(c.frequency, c.deviation,
                                    enc.params.sample_rate, c.level_int)
    t = time.perf_counter()
    fx.process(feed, 0)
    carrier_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    out.cpu()
    d2h_s = time.perf_counter() - t
    phase("fm-host", samples=n, feed_s=f"{feed_s:.4f}",
          carrier_recurrence_s=f"{carrier_s:.4f}", d2h_s=f"{d2h_s:.4f}",
          d2h_gb_per_s=f"{out.numel() * 2 / d2h_s / 1e9:.2f}",
          card=json.dumps(CARD["smi"]))


def profile_block(enc, b, path, out_dir):
    """Kernel times of one block under torch.profiler, to a file, and
    the block's count of device activities (kernels and copies) and
    their summed device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        enc.encode_block_device(b)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(out_dir, f"profile_{path}.txt"), "w") as f:
        f.write(table)
    dev = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    phase("profile", path=path, device_activities=len(dev),
          device_ms=f"{sum(dev) / 1e3:.2f}",
          file=os.path.join(out_dir, f"profile_{path}.txt"))


def mac_compare_phase() -> None:
    """The MAC configurations, one-frame blocks 0-3 (two-frame where the
    entry says), card against the CPU with TF32 off and on."""
    was = torch.backends.cuda.matmul.allow_tf32
    for path, spec in MAC_CPU_PATHS.items():
        fpb = spec[2].get("fpb", 1)
        src = mac_noise_source(spec)
        c = build_mac(spec, "cpu", src, fpb)
        ref = [c.encode_block(b).astype(np.int64) for b in range(CPU_BLOCKS)]
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                g = build_mac(spec, "cuda", src, fpb)
                got = [g.encode_block(b).astype(np.int64)
                       for b in range(CPU_BLOCKS)]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = was
            for b, (a, r) in enumerate(zip(got, ref)):
                if a.shape != r.shape:
                    fail(f"{path} block {b}: shape {a.shape} != {r.shape}")
                nd = int(np.count_nonzero(a != r))
                phase("card-vs-cpu", path=path, block=b,
                      tf32="on" if tf32 else "off", frames=fpb,
                      max_err=int(np.abs(a - r).max()), differing=nd,
                      of=a.size)
                if nd:
                    fail(f"{path} block {b}: card and CPU differ")


def cpu_compare_phase() -> None:
    for path, spec in CPU_PATHS.items():
        src = noise_source(spec)
        g = build(spec, "cuda", src)
        c = build(spec, "cpu", src)
        if path.endswith("-angle") and g.statics.carrier_rows is not None:
            fail(f"{path}: the mode has exact carrier rows at this rate")
        for b in range(CPU_BLOCKS):
            a = g.encode_block(b).astype(np.int64)
            r = c.encode_block(b).astype(np.int64)
            if a.shape != r.shape:
                fail(f"{path} block {b}: shape {a.shape} != {r.shape}")
            d = a - r
            noise = float(np.sum(d.astype(np.float64) ** 2))
            snr = (float("inf") if noise == 0 else 10 * np.log10(
                float(np.sum(r.astype(np.float64) ** 2)) / noise))
            phase("card-vs-cpu", path=path, block=b, snr_db=f"{snr:.1f}",
                  max_err=int(np.abs(d).max()),
                  differing=int(np.count_nonzero(d)), of=d.size)
            if np.count_nonzero(d):
                fail(f"{path} block {b}: card and CPU differ")


def cli_phase() -> None:
    """Four frames from the command line to a file through the native
    sink: PAL-I, PAL-FM with the pre-emphasis filter, PAL S-Video with the
    low-pass, PAL-I from 14.75 MS/s pixels, PAL-I with teletext, WSS,
    VITS and VITC through the VSB filter (the teletext clock fixed),
    PAL-I with Videocrypt through the VSB filter, PAL-I with SiS through
    the VSB filter, ntsc-bs, D2-MAC FM with Eurocrypt and baseband D-MAC
    with the double cut (real output: the sink writes one int16 a
    sample)."""
    demo = os.path.join(HERE, "tests", "data", "demo.tti")
    env = {**os.environ, "HACKTV_TPU_TELETEXT_TIME": str(TELETEXT_TIME)}
    with tempfile.TemporaryDirectory() as tmp:
        # (arguments, int16 values a frame: samples times I and Q)
        cases = ((["-m", "i"], 2 * 640_000),
                 (["-m", "i", "--filter", "--teletext", demo, "--wss",
                   "16:9", "--vits", "--vitc"], 2 * 640_000),
                 (["-m", "pal-fm", "--filter", "-s", "20250000"],
                  2 * 810_000),
                 (["-m", "pal", "--s-video", "--filter"], 2 * 640_000),
                 (["-m", "i", "--pixelrate", "14750000"], 2 * 640_000),
                 (["-m", "i", "--filter", "--videocrypt", "free"],
                  2 * 640_000),
                 (["-m", "i", "--filter", "--sis", "dcsis"], 2 * 640_000),
                 (["-m", "ntsc-bs"], 2 * 533_925),
                 (["-m", "d2mac-fm", "--eurocrypt", "ctv", "-s",
                   "20250000"], 2 * 810_000),
                 (["-m", "dmac", "--double-cut", "-s", "20250000"],
                  810_000))
        runs = [(args, fv, os.path.join(tmp, f"out{k}.bin"))
                for k, (args, fv) in enumerate(cases)]
        # CLI_AT_ONCE processes at a time share the card: a run is
        # mostly the interpreter's and the card's start
        done = []
        for i in range(0, len(runs), CLI_AT_ONCE):
            t = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-m", "hacktv_tpu_torch", *args,
                 "--frames", "4", "-o", out, "test"],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True, env=env) for args, _, out in
                runs[i:i + CLI_AT_ONCE]]
            try:
                for p in procs:
                    err = p.communicate(timeout=600)[1]
                    done.append((p.returncode, err,
                                 time.perf_counter() - t))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        for (args, frame_values, out), (rc, err, secs) in zip(runs, done):
            if rc != 0:
                fail(f"cli {args} exited {rc}: {err[-2000:]}")
            size = os.path.getsize(out)
            data = np.fromfile(out, np.int16)
            phase("cli", args="".join(a for a in args if a != demo),
                  bytes=size, seconds=f"{secs:.1f}",
                  at_once=CLI_AT_ONCE)
            if size != 4 * frame_values * 2:
                fail(f"cli {args} wrote {size} bytes, expected "
                     f"{4 * frame_values * 2}")
            if not np.any(data):
                fail(f"cli {args} wrote only zeros")
    # -o hackrf on a machine with no HackRF: a non-zero exit naming the
    # library (or the device that did not answer), and no file
    with tempfile.TemporaryDirectory() as tmp:
        args = ["-m", "i", "--frames", "1", "-o", "hackrf", "test"]
        r = subprocess.run(
            [sys.executable, "-m", "hacktv_tpu_torch", *args], cwd=tmp,
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": HERE})
        named = "libhackrf" in r.stderr or "hackrf:" in r.stderr
        phase("cli", args="".join(args), exit=r.returncode,
              names_hackrf=named, files=len(os.listdir(tmp)))
        if r.returncode == 0 or not named or os.listdir(tmp):
            fail(f"cli {args}: exit {r.returncode}, files "
                 f"{os.listdir(tmp)}: {r.stderr[-2000:]}")


def moving_cli_phase() -> None:
    """The moving file from the command line: 128 frames of PAL-I through
    the VSB filter in 64-frame blocks, stretched and letterboxed, to a
    file through the native sink; each checked for its byte count."""
    spec = "raw:{}:{}x{}".format(MOTION["path"], *MOTION_SIZE)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.bin")
        for extra in ([], ["--letterbox"]):
            args = ["-m", "i", "--filter", "--frames-per-block", "64",
                    "--frames", "128", *extra]
            t = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "hacktv_tpu_torch", *args, "-o", out,
                 spec], capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                fail(f"cli {args} exited {r.returncode}: {r.stderr[-2000:]}")
            size = os.path.getsize(out)
            phase("cli", args="".join(args) + "raw:motion.raw:720x576",
                  bytes=size, seconds=f"{time.perf_counter() - t:.1f}")
            if size != 128 * 640_000 * 2 * 2:
                fail(f"cli {args} wrote {size} bytes, expected "
                     f"{128 * 640_000 * 4}")
            if not np.any(np.fromfile(out, np.int16, count=1 << 20)):
                fail(f"cli {args} wrote only zeros")
            os.remove(out)


# ---------------------------------------------------------------------------
# hw-sink: the hardware sinks fed from the card at the device's own pace


class PacedLib:
    """A vendor library with libhackrf's and libosmo-fl2k's entry points
    whose TX thread calls the driver's ctypes callback at the device's
    clock: HackRF transfers of HACKRF_TRANSFER bytes, one every
    HACKRF_TRANSFER / (2 * rate) s, or FL2K transfers of FL2K_TRANSFER
    samples on each of R, G and B, one every FL2K_TRANSFER / rate s.  The
    schedule is monotonic (transfer k is due at t0 + k * period) and
    catches up when late; each transfer's lateness and offset are kept.

    The thread waits for `arm(probe)`, called once the sink is open;
    `probe()` gives the sink's (underruns, FIFO level) after each
    transfer.  A transfer that adds no underrun marks the prefill: from
    there on the pulled bytes (HackRF: the int8 stream; FL2K: R, whose
    FIFO has the prefill) are kept for the check against the producer,
    with the lowest FIFO level and the underruns after it.  `wall` is
    the time from arm to stop."""

    def __init__(self, rate: int):
        self.rate = int(rate)
        self._armed = threading.Event()
        self._halt = threading.Event()
        self._thread = None
        self.probe = None
        self.late = []              # seconds past each transfer's time
        self.offsets = []           # each transfer's first byte (sample)
        self.pulled = 0             # bytes, every channel
        self.prefill_at = None      # the first transfer after the prefill
        self.under_before = 0
        self.under_total = 0
        self.fifo_min = None
        self.kept = []              # the pulled transfers past the prefill
        self.under_at = []          # seconds after arm of each underrun
                                    # after the prefill
        self.error = None
        self._t_arm = None
        self.wall = None

    def arm(self, probe) -> None:
        self.probe = probe
        self._t_arm = time.monotonic()
        self._armed.set()

    # libhackrf
    def hackrf_init(self):
        return 0

    def hackrf_open_by_serial(self, serial, dev):
        dev._obj.value = 1
        return 0

    def hackrf_version_string_read(self, dev, buf, n):
        buf.value = b"paced-fake"
        return 0

    def hackrf_compute_baseband_filter_bw(self, rate):
        return 1_750_000

    def hackrf_set_sample_rate_manual(self, *a):
        return 0

    hackrf_set_baseband_filter_bandwidth = hackrf_set_sample_rate_manual
    hackrf_set_freq = hackrf_set_sample_rate_manual
    hackrf_set_txvga_gain = hackrf_set_sample_rate_manual
    hackrf_set_amp_enable = hackrf_set_sample_rate_manual
    hackrf_close = hackrf_set_sample_rate_manual
    hackrf_exit = hackrf_set_sample_rate_manual

    def hackrf_start_tx(self, dev, cb, ctx):
        self._start(self._run_hackrf, cb)
        return 0

    def hackrf_stop_tx(self, dev):
        self._stop()
        return 0

    # libosmo-fl2k
    def fl2k_open(self, dev, index):
        dev._obj.value = 1
        return 0

    def fl2k_start_tx(self, dev, cb, ctx, buf_num):
        self._start(self._run_fl2k, cb)
        return 0

    def fl2k_set_sample_rate(self, dev, rate):
        return 0

    def fl2k_stop_tx(self, dev):
        self._stop()
        return 0

    fl2k_close = fl2k_set_sample_rate

    def _start(self, run, cb):
        self._thread = threading.Thread(target=self._guard, args=(run, cb),
                                        daemon=True)
        self._thread.start()

    def _stop(self):
        if self._t_arm is not None:
            self.wall = time.monotonic() - self._t_arm
        self._halt.set()
        self._armed.set()
        if self._thread is not None:
            self._thread.join(timeout=60)

    def _guard(self, run, cb):
        try:
            run(cb)
        except Exception as e:        # reported by the phase
            self.error = e

    def _transfers(self, period):
        """Yield at each transfer's time until stopped."""
        self._armed.wait()
        t0 = time.monotonic()
        k = 0
        while not self._halt.is_set():
            due = t0 + k * period
            now = time.monotonic()
            if now < due:
                if self._halt.wait(due - now):
                    return
                now = time.monotonic()
            self.late.append(now - due)
            yield k
            k += 1

    def _after(self, data: bytes) -> None:
        under, level = self.probe()
        if self.prefill_at is not None and under != self.under_total:
            self.under_at.append(time.monotonic() - self._t_arm)
        if self.prefill_at is None:
            if under == self.under_total:
                self.prefill_at = len(self.offsets) - 1
                self.under_before = under
        if self.prefill_at is not None:
            self.kept.append(data)
            self.fifo_min = (level if self.fifo_min is None
                             else min(self.fifo_min, level))
        self.under_total = under

    def _run_hackrf(self, cb):
        n = HACKRF_TRANSFER
        t = cb.argtypes[0]._type_()
        buf = (ctypes.c_uint8 * n)()
        t.buffer = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
        t.buffer_length = t.valid_length = n
        for k in self._transfers(n / (2 * self.rate)):
            self.offsets.append(k * n)
            if cb(ctypes.pointer(t)) != 0:      # the end of the stream
                return
            self.pulled += n
            self._after(bytes(buf))

    def _run_fl2k(self, cb):
        n = FL2K_TRANSFER
        info = cb.argtypes[0]._type_()
        for k in self._transfers(n / self.rate):
            self.offsets.append(k * n)
            info.len = n
            cb(ctypes.pointer(info))
            self.pulled += 3 * n
            self._after(ctypes.string_at(info.r_buf, n))


def attach(sink, lib, kind: str, produced: list) -> None:
    """Arm the paced library on an open sink: its probe, and the
    producer's side, the sink's own conversion of every block written
    (HackRF: int8 pairs; FL2K: R, the I channel)."""
    from hacktv_tpu_torch import runtime
    write = sink.write
    if kind == "hackrf":
        probe = lambda: (sink.underruns, sink.fifo.level())
        conv = lambda iq: runtime.convert_hackrf_iq8(iq.reshape(-1))
    else:
        probe = lambda: (sink.underruns, sink.fifo_r.level())
        conv = lambda iq: runtime.convert_fl2k_u8(iq, 0)

    def recorded(iq):
        produced.append(conv(np.ascontiguousarray(iq, np.int16)).tobytes())
        write(iq)
    sink.write = recorded
    lib.arm(probe)


def feed(enc, sink, frames: int) -> None:
    """The command line's loop over a sink: block b + 1 queued on the card
    before block b is collected and written, the block's 32 kHz sound to
    the sink's audio side-channel; then the sink closed."""
    fpb = enc.frames_per_block
    pending, block = None, 0
    while True:
        nxt = None
        if block * fpb < frames:
            nxt = (block, enc.encode_block_device(block))
            block += 1
        if pending is not None:
            b0, dev = pending
            out = enc.collect_block(b0, dev)
            if out.ndim == 1:
                out = np.stack([out, np.zeros_like(out)], axis=-1)
            sink.write(out)
            pcm = enc.block_audio_pcm(b0)
            if pcm is not None and len(pcm):
                sink.write_audio(pcm)
        pending = nxt
        if pending is None:
            break
    sink.close()


def hw_sink_run(name: str, kind: str, rate: int, frames: int,
                fir: str, drive, gate_underruns: bool = False) -> int:
    """One run of the hw-sink phase: drive(lib, produced) feeds a sink of
    `kind` on a PacedLib and returns it, closed; the run's line, and the
    gates (with gate_underruns, an underrun after the prefill fails the
    run).  Returns the count of the run's `fir` launches."""
    import contextlib
    import hashlib
    import io
    lib = PacedLib(rate)
    produced = []
    since = fir_launches()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        sink = drive(lib, produced)
    launches = fir_launches(since)
    if lib.error is not None:
        fail(f"hw-sink {name}: the paced callback raised {lib.error!r}")
    if lib._thread is None or lib._thread.is_alive():
        fail(f"hw-sink {name}: the transfer thread did not stop")
    after = lib.under_total - lib.under_before
    late = np.array(lib.late) * 1e3
    # the pulled stream past its leading zero-fill against the producer's
    # conversion of the blocks (a prefix: the sink stops the device at
    # close, with the FIFO's rest unsent)
    compared, verdict = 0, "skipped (underruns after the prefill)"
    if lib.prefill_at is None:
        verdict = "nothing pulled past the prefill"
    elif after == 0:
        got = hashlib.sha256()
        for data in lib.kept:
            got.update(data)
        compared = sum(len(d) for d in lib.kept)
        stream = b"".join(produced)
        ref = hashlib.sha256(stream[:compared])
        verdict = ("equal" if compared <= len(stream)
                   and got.hexdigest() == ref.hexdigest() else "differs")
    bpsamp = 2 if kind == "hackrf" else 1
    fifo_min = lib.fifo_min
    phase("hw-sink", run=name, sink=kind, signal_s=f"{frames / 25:.2f}",
          wall_s=f"{lib.wall:.2f}", transfers=len(lib.offsets),
          underruns_before_prefill=lib.under_before,
          underruns_after_prefill=after,
          # the FL2K sink keeps no shortfall length
          longest_shortfall_bytes=getattr(sink, "longest_shortfall", "-"),
          fifo_min_after_prefill_bytes=fifo_min,
          fifo_min_after_prefill_s=(
              f"{fifo_min / (bpsamp * rate):.3f}" if fifo_min is not None
              else "-"),
          late_p99_ms=f"{np.percentile(late, 99):.3f}" if len(late) else "-",
          late_max_ms=f"{late.max():.3f}" if len(late) else "-",
          underruns_after_prefill_at_s=(
              f"{lib.under_at[0]:.2f}-{lib.under_at[-1]:.2f}"
              if lib.under_at else "-"),
          bytes_pulled=lib.pulled, compared_bytes=compared, stream=verdict,
          launches=json.dumps(launches).replace(" ", ""),
          stderr_U=err.getvalue().count("U"), card=json.dumps(CARD["smi"]))
    other = err.getvalue().replace("U", "").strip()
    if other:
        print(f"  {name} stderr: {other[-2000:]}")
    if not launches[fir]:
        fail(f"hw-sink {name}: {fir} was not launched")
    if verdict.startswith("differs") or verdict.startswith("nothing"):
        fail(f"hw-sink {name}: the pulled stream {verdict}")
    if gate_underruns and after:
        fail(f"hw-sink {name}: {after} underruns after the prefill")
    return launches[fir]


def hw_sink_phase() -> dict:
    """The hardware sinks at full width, paced by PacedLib at the
    device's clock: pal-i-vsb through the command line (-m i --filter -f
    855250000 -g 47 -o hackrf, 200 frames in its 16-frame blocks, with
    hardware._find_lib returning the paced library), i-moving-vsb through
    open_sink("hackrf") at 8 and at 64 frames a block (HW_MOVING_FRAMES
    frames of the moving file), and pal-lowpass through open_sink("fl2k")
    (HW_LOWPASS_FRAMES frames, real output: fir_real).  pal-i-vsb must
    show no underrun after the prefill; every run without one must pull
    the producer's bytes.  Returns each run's e2e path and launches."""
    from hacktv_tpu_torch import cli
    from hacktv_tpu_torch.rf import hardware
    counts = {}

    def via_cli(lib, produced):
        find, open_sink = hardware._find_lib, hardware.open_sink
        opened_sinks = []

        def opened(*a, **kw):
            sink = open_sink(*a, **kw)
            attach(sink, lib, "hackrf", produced)
            opened_sinks.append(sink)
            return sink
        hardware._find_lib = lambda names: lib
        hardware.open_sink = opened
        try:
            rc = cli.main(HW_SINK_CLI)
        finally:
            hardware._find_lib, hardware.open_sink = find, open_sink
        if rc != 0 or len(opened_sinks) != 1:
            fail(f"hw-sink: the command line exited {rc}")
        return opened_sinks[0]
    counts["pal-i-vsb-cli"] = ("pal-i-vsb", hw_sink_run(
        "pal-i-vsb-cli", "hackrf", 16_000_000,
        int(HW_SINK_CLI[HW_SINK_CLI.index("--frames") + 1]), "fir_cplx",
        via_cli, gate_underruns=True))

    def via_open_sink(path, fpb, kind, frames):
        def drive(lib, produced):
            enc, rate, _ = make_path(path, "cuda", fpb)
            complex_out = enc.complex_out
            sink = hardware.open_sink(
                kind, None, rate, frequency=855_250_000, gain=47,
                complex_out=complex_out, baseband=not complex_out,
                fl2k_audio="none", lib=lib)
            attach(sink, lib, kind, produced)
            feed(enc, sink, frames)
            return sink
        return drive
    for fpb in HW_MOVING_FPB:
        name = f"i-moving-vsb-{fpb}f"
        counts[name] = ("i-moving-vsb", hw_sink_run(
            name, "hackrf", 16_000_000, HW_MOVING_FRAMES, "fir_cplx",
            via_open_sink("i-moving-vsb", fpb, "hackrf", HW_MOVING_FRAMES)))
        torch.cuda.empty_cache()
    counts["pal-lowpass-fl2k"] = ("pal-lowpass", hw_sink_run(
        "pal-lowpass-fl2k", "fl2k", 16_000_000, HW_LOWPASS_FRAMES,
        "fir_real", via_open_sink("pal-lowpass", 16, "fl2k",
                                  HW_LOWPASS_FRAMES)))
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None, metavar="DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)

    from hacktv_tpu_torch import runtime
    from hacktv_tpu_torch.config import get_mode
    from hacktv_tpu_torch.encoder import Encoder
    from hacktv_tpu_torch.ops import cuda_build
    from hacktv_tpu_torch.ops import stream_fir as sf
    from hacktv_tpu_torch.video.params import VideoParams

    kind = card()
    t_start = t = LAP["t"] = time.perf_counter()
    # g++ on the native runtime beside nvcc on each kernel source
    rt = {}

    def build_runtime():
        try:
            rt["built"] = runtime.build()
            rt["s"] = time.perf_counter() - t
        except Exception as e:          # reported after the join
            rt["error"] = e
    rt_thread = threading.Thread(target=build_runtime)
    rt_thread.start()
    reports = cuda_build.build_all()
    rt_thread.join()
    if "error" in rt:
        fail(f"native runtime build: {rt['error']}")
    runtime.load()
    phase("build", seconds=f"{time.perf_counter() - t:.1f}",
          built=",".join(sorted(reports)) or "none",
          native_runtime=("built" if rt["built"] else "up to date"),
          native_runtime_s=f"{rt['s']:.1f}")
    for name, rep in reports.items():
        for line in rep.strip().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    sass_mix(cuda_build.lib_path("stream_fir"))
    recs = kernel_phase(sf, VideoParams, get_mode)
    lap("build and kernels")
    nicam_phase(Encoder)
    lap("nicam")
    secam_phase(Encoder)
    lap("secam")
    resample_phase()
    lap("resample")
    vbi_phase()
    lap("vbi")
    scramble_phase()
    lap("scramble")
    dance_phase()
    lap("dance")
    mac_phase()
    lap("mac")
    launches = {}
    with tempfile.TemporaryDirectory() as motion_dir:
        t = time.perf_counter()
        MOTION["path"] = write_motion(motion_dir)
        phase("motion", frames=MOTION_FRAMES, size="{}x{}".format(
            *MOTION_SIZE), bytes=os.path.getsize(MOTION["path"]),
            seconds=f"{time.perf_counter() - t:.1f}")
        for path in (*PATHS, *MOVING_PATHS, *MAC_PATHS):
            launches[path] = e2e_phase(path, args.profile)
        lap("e2e")
        for path, rec in recs:
            rec["launches"] = launches[path][
                "fir_cplx" if rec["name"].endswith("cplx") else "fir_real"]
            if not rec["launches"]:
                fail(f"{path}: {rec['name']} was not launched on the main "
                     "path")
        bench_phase()
        lap("bench")
        sink_counts = hw_sink_phase()
        for path, rec in recs:
            rec["hw_sink_launches"] = {
                run: n for run, (p, n) in sink_counts.items() if p == path}
        lap("hw-sink")
        cpu_compare_phase()
        lap("card-vs-cpu")
        mac_compare_phase()
        lap("mac card-vs-cpu")
        moving_phase()
        lap("moving")
        checkpoint_phase()
        lap("checkpoint")
        sharded = devices_phase(sf)
        for path, rec in recs:
            rec["sharded_launches"] = sharded[
                "fir_cplx" if rec["name"].endswith("cplx") else "fir_real"]
            if not rec["sharded_launches"]:
                fail(f"{rec['name']} was not launched on a sharded path")
        lap("devices")
        hosts_phase()
        lap("hosts")
        cli_phase()
        lap("cli")
        moving_cli_phase()
        lap("moving cli")
    phase("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [rec for _, rec in recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
