"""OpenCV-decoded video-file AV source.

Fallback moving-video input when no ffmpeg binary is on PATH: OpenCV's
bundled ffmpeg decodes the file; frames are rate-converted to the
target frame rate by drop/repeat (the reference's PTS-based sync,
src/av_ffmpeg.c:550-753, collapses to the same nearest-frame mapping
for CFR input).  Audio comes from a `<path>.pcm` side-car (32 kHz
stereo s16le) and EIA-608 byte pairs from `<path>.cc608`, like the
raw: source — OpenCV exposes neither audio nor A53 side data.
"""

from __future__ import annotations

import os
from fractions import Fraction

import numpy as np

AUDIO_RATE = 32000


class OpenCVSource:
    def __init__(self, path: str, width: int, height: int,
                 frame_rate=(25, 1)):
        import cv2
        if not os.path.exists(path):
            raise SystemExit(f"input file not found: {path}")
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise SystemExit(f"OpenCV cannot decode {path}; install "
                             "ffmpeg or use raw:")
        num, den = (frame_rate.num, frame_rate.den) \
            if hasattr(frame_rate, "num") else frame_rate
        self._out_rate = Fraction(num, den)
        fps = self._cap.get(cv2.CAP_PROP_FPS) or float(self._out_rate)
        self._in_rate = Fraction(fps).limit_denominator(1001) \
            if fps > 0 else self._out_rate
        sn = self._cap.get(getattr(cv2, "CAP_PROP_SAR_NUM", -1)) \
            if hasattr(cv2, "CAP_PROP_SAR_NUM") else 0
        sd = self._cap.get(getattr(cv2, "CAP_PROP_SAR_DEN", -1)) \
            if hasattr(cv2, "CAP_PROP_SAR_DEN") else 0
        self.pixel_aspect_ratio = (Fraction(int(sn), int(sd))
                                   if sn > 0 and sd > 0
                                   else Fraction(1, 1))
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)) \
            or width
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) \
            or height
        self.interlaced = 0

        self._in_no = -1               # decoder position
        self._frame = np.zeros((self.height, self.width, 3), np.uint8)
        self._eof = False

        self._audio = np.zeros((0, 2), dtype=np.int16)
        pcm = path + ".pcm"
        if os.path.exists(pcm):
            raw = np.fromfile(pcm, dtype=np.int16)
            self._audio = raw[: len(raw) // 2 * 2].reshape(-1, 2)
        self._cc = np.zeros((0, 2), dtype=np.uint8)
        cc = path + ".cc608"
        if os.path.exists(cc):
            raw = np.fromfile(cc, dtype=np.uint8)
            self._cc = raw[: len(raw) // 2 * 2].reshape(-1, 2)

    def read_video(self, frame_no: int) -> np.ndarray:
        # output frame n shows input frame floor(n * in_rate/out_rate)
        want = int(frame_no * self._in_rate / self._out_rate)
        while self._in_no < want and not self._eof:
            ok, fr = self._cap.read()
            if not ok:
                self._eof = True
                break
            self._frame = fr[:, :, ::-1].copy()   # BGR -> RGB
            self._in_no += 1
        return self._frame

    def read_audio(self, start: int, count: int) -> np.ndarray:
        out = np.zeros((count, 2), dtype=np.int16)
        got = self._audio[start:start + count]
        out[:len(got)] = got
        return out

    def read_cc608(self, frame_no: int):
        if frame_no < len(self._cc):
            return int(self._cc[frame_no, 0]), int(self._cc[frame_no, 1])
        return 0, 0

    def eof(self, frame_no: int) -> bool:
        if not self._eof:
            return False
        return int(frame_no * self._in_rate / self._out_rate) > self._in_no

    def close(self) -> None:
        self._cap.release()
