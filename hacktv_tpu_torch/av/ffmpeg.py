"""ffmpeg-based AV input (host side).

The reference links libavcodec and runs five decode/scale/resample
threads (src/av_ffmpeg.c).  Here decode stays on the host CPU either
way, so we drive the `ffmpeg` *binary* through two pipes — one decoding
video to raw RGB24 frames at native resolution and the target frame
rate (CFR: ffmpeg drops/repeats like the reference's PTS sync,
src/av_ffmpeg.c:550-753), one decoding audio to 32 kHz stereo s16le
(the reference's fixed internal audio format, src/hacktv.h:31).

A probe pass parses the stream's pixel aspect ratio (exposed as
`pixel_aspect_ratio` for the fit geometry, src/av_ffmpeg.c:606-680)
and whether an audio stream exists.  `ffmt`/`fopts` map to the
reference's --ffmt/--fopts (forced input format + demuxer options,
src/hacktv.c:520-524, src/av_ffmpeg.c:1022-1031).

EIA-608 captions: the ffmpeg *binary* cannot expose libav's decoded
frame side data (the reference's path, src/av_ffmpeg.c:566-581), so
in-stream A53 pairs are recovered from a codec-copied elementary
stream pipe (av/a53.py — MPEG-2 ATSC user data, H.264/H.265 T.35
SEI).  A `<path>.cc608` side-car of one byte pair per frame overrides
the in-stream path when present.

When the binary is missing, `open_video_source` falls back to the
OpenCV decoder (av/videofile.py), which covers moving-video input in
environments without ffmpeg.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from fractions import Fraction

import numpy as np

AUDIO_RATE = 32000


def _probe(binary, path, ffmt=None, fopts=None):
    """Parse `ffmpeg -i` stream info in ONE subprocess run:
    (par, has_audio, native_width, native_height)."""
    cmd = list(binary) + ["-hide_banner"]
    cmd += _input_args(path, ffmt, fopts)
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=30)
        text = r.stderr.decode("utf-8", "replace")
    except Exception:
        return Fraction(1, 1), True, None, None
    par = Fraction(1, 1)
    m = re.search(r"Video:.*?\bSAR (\d+):(\d+)\b", text)
    if m and int(m.group(1)) > 0 and int(m.group(2)) > 0:
        par = Fraction(int(m.group(1)), int(m.group(2)))
    has_audio = re.search(r"Stream #.*Audio:", text) is not None
    width = height = None
    m = re.search(r"Video:.*?\b(\d{2,5})x(\d{2,5})\b", text)
    if m:
        width, height = int(m.group(1)), int(m.group(2))
    vcodec = None
    m = re.search(r"Video:\s*(\w+)", text)
    if m:
        vcodec = m.group(1)
    return par, has_audio, width, height, vcodec


def _input_args(path, ffmt, fopts):
    args = []
    if ffmt:
        args += ["-f", ffmt]
    if fopts:
        # option=value[:option2=value2] (src/av_ffmpeg.c:1027-1031)
        for kv in fopts.split(":"):
            if "=" in kv:
                k, v = kv.split("=", 1)
                args += ["-" + k, v]
    return args + ["-i", path]


class FFmpegSource:
    def __init__(self, path: str, width: int, height: int,
                 frame_rate=(25, 1), loop: bool = False,
                 ffmt: str | None = None, fopts: str | None = None,
                 binary=None):
        if binary is None:
            if shutil.which("ffmpeg") is None:
                raise SystemExit(
                    "ffmpeg input requires the ffmpeg binary on PATH; "
                    "use 'test', 'raw:' or an OpenCV-decodable file")
            binary = ["ffmpeg"]
        elif isinstance(binary, str):
            binary = [binary]
        self.path = path
        self.interlaced = 0
        self.loop = loop
        num, den = (frame_rate.num, frame_rate.den) \
            if hasattr(frame_rate, "num") else frame_rate

        self.pixel_aspect_ratio, has_audio, nat_w, nat_h, vcodec = \
            _probe(binary, path, ffmt, fopts)
        # native decode size from the probe; the fit geometry
        # (FitSource) letterboxes/scales downstream using the PAR
        inp = _input_args(path, ffmt, fopts)
        self._vproc = subprocess.Popen(
            list(binary) + ["-nostdin", "-v", "error"] + inp +
            ["-f", "rawvideo", "-pix_fmt", "rgb24",
             "-r", f"{num}/{den}", "-"],
            stdout=subprocess.PIPE)
        self._aproc = None
        if has_audio:
            self._aproc = subprocess.Popen(
                list(binary) + ["-nostdin", "-v", "error"] + inp +
                ["-f", "s16le", "-acodec", "pcm_s16le",
                 "-ar", str(AUDIO_RATE), "-ac", "2", "-"],
                stdout=subprocess.PIPE)

        # frame geometry: need the native size; probe text is the
        # authority but the caller's (width, height) is the fallback
        self.width = nat_w if nat_w else width
        self.height = nat_h if nat_h else height

        self._frame_no = -1
        self._frame = np.zeros((self.height, self.width, 3),
                               dtype=np.uint8)
        self._eof = False
        # bounded sliding audio window: consumers pull nearly
        # monotonically with < 1 s of lookback (limiter/J17 history),
        # so old history is pruned instead of concatenating forever
        self._audio = np.zeros((0, 2), dtype=np.int16)
        self._audio_base = 0           # stream pair index of _audio[0]
        self._audio_keep = 4 * AUDIO_RATE
        self._audio_eof = self._aproc is None

        # EIA-608 captions: a `<path>.cc608` side-car (one byte pair per
        # frame) takes priority; otherwise in-stream A53 extraction from
        # the codec-copied elementary stream (the reference reads them
        # from decoder frame side data, src/av_ffmpeg.c:566-581)
        self._cc = None
        self._a53 = None
        self._a53_proc = None
        self._a53_fifo: list = []
        cc = path + ".cc608"
        if os.path.exists(cc):
            raw = np.fromfile(cc, dtype=np.uint8)
            self._cc = raw[: len(raw) // 2 * 2].reshape(-1, 2)
        elif vcodec in ("mpeg2video", "h264", "hevc"):
            from .a53 import A53ESParser
            self._a53 = A53ESParser(vcodec)
            self._a53_proc = subprocess.Popen(
                list(binary) + ["-nostdin", "-v", "error"] + inp +
                ["-map", "0:v:0", "-c:v", "copy", "-f", vcodec, "-"],
                stdout=subprocess.PIPE)

    def read_video(self, frame_no: int) -> np.ndarray:
        nbytes = self.width * self.height * 3
        while self._frame_no < frame_no and not self._eof:
            raw = self._vproc.stdout.read(nbytes)
            if len(raw) < nbytes:
                self._eof = True
                break
            self._frame = np.frombuffer(raw, dtype=np.uint8).reshape(
                self.height, self.width, 3).copy()
            self._frame_no += 1
        return self._frame

    def read_audio(self, start: int, count: int) -> np.ndarray:
        if start < self._audio_base:
            raise ValueError(
                f"audio seek before the sliding window ({start} < "
                f"{self._audio_base}); increase the keep margin")
        need = start + count
        while self._audio_base + len(self._audio) < need \
                and not self._audio_eof:
            have = self._audio_base + len(self._audio)
            raw = self._aproc.stdout.read(4 * max(need - have, AUDIO_RATE))
            if not raw:
                self._audio_eof = True
                break
            chunk = np.frombuffer(raw[:len(raw) // 4 * 4],
                                  dtype=np.int16).reshape(-1, 2)
            self._audio = np.concatenate([self._audio, chunk])
        out = np.zeros((count, 2), dtype=np.int16)
        lo = start - self._audio_base
        got = self._audio[lo:lo + count]
        out[:len(got)] = got
        # prune consumed history beyond the lookback margin
        drop = lo - self._audio_keep
        if drop > 0:
            self._audio = self._audio[drop:]
            self._audio_base += drop
        return out

    def read_cc608(self, frame_no: int):
        """EIA-608 byte pair for frame_no ((0, 0) when none): the
        side-car when present, else in-stream A53 pairs drained one per
        frame like the reference's cc608 FIFO
        (src/av_ffmpeg.c:566-581, src/video.c per-frame read)."""
        if self._cc is not None:
            if frame_no < len(self._cc):
                return (int(self._cc[frame_no, 0]),
                        int(self._cc[frame_no, 1]))
            return 0, 0
        if self._a53 is None:
            return 0, 0
        # pull the elementary stream until the parser has flushed past
        # this frame's picture (or EOF)
        while self._a53_proc is not None \
                and self._a53.pictures <= frame_no:
            chunk = self._a53_proc.stdout.read(1 << 16)
            if not chunk:
                self._a53_fifo.extend(self._a53.feed(b"", final=True))
                self._a53_proc.stdout.close()
                self._a53_proc.wait()
                self._a53_proc = None
                break
            self._a53_fifo.extend(self._a53.feed(chunk))
        if self._a53_fifo:
            return self._a53_fifo.pop(0)
        return 0, 0

    def eof(self, frame_no: int) -> bool:
        return self._eof and frame_no > self._frame_no

    def close(self) -> None:
        for p in (self._vproc, self._aproc, self._a53_proc):
            if p is not None:
                if p.poll() is None:
                    p.kill()
                p.wait()


def open_video_source(path: str, width: int, height: int,
                      frame_rate=(25, 1), ffmt=None, fopts=None):
    """ffmpeg binary when available, OpenCV decoder otherwise."""
    if shutil.which("ffmpeg") is not None:
        return FFmpegSource(path, width, height, frame_rate=frame_rate,
                            ffmt=ffmt, fopts=fopts)
    if ffmt or fopts:
        raise SystemExit("--ffmt/--fopts require the ffmpeg binary, "
                         "which is not on PATH")
    from .videofile import OpenCVSource
    return OpenCVSource(path, width, height, frame_rate=frame_rate)
