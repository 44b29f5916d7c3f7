"""Raw RGB32 frame-file AV source.

Reads fixed-size frames of 32-bit 0xAARRGGBB pixels (the reference's
internal frame format, src/av.h:31-54) from a file, with an optional
side-car PCM file `<path>.pcm` of 32 kHz stereo s16le audio.  Useful as
a dependency-free input path (ffmpeg can produce it:
`ffmpeg -i in.mp4 -f rawvideo -pix_fmt bgra out.raw`).
"""

from __future__ import annotations

import os

import numpy as np


class RawFileSource:
    def __init__(self, spec: str, width: int, height: int):
        # spec: path[:WxH]
        path, sep, dims = spec.partition(":")
        if sep and "x" in dims:
            w, h = (int(v) for v in dims.split("x"))
        else:
            path, w, h = spec, width, height
        self.path = path
        self.width = w
        self.height = h
        self.interlaced = 0
        self._fsize = os.path.getsize(path)
        self._frame_bytes = w * h * 4
        self.n_frames = self._fsize // self._frame_bytes
        self._f = open(path, "rb")
        self._cache: tuple[int, np.ndarray] | None = None

        self._audio = np.zeros((0, 2), dtype=np.int16)
        pcm = path + ".pcm"
        if os.path.exists(pcm):
            raw = np.fromfile(pcm, dtype=np.int16)
            self._audio = raw[: len(raw) // 2 * 2].reshape(-1, 2)
        # optional EIA-608 side channel: <path>.cc608 holds one byte
        # pair per frame (the reference gets these from ffmpeg A53 side
        # data, src/av_ffmpeg.c:566-581)
        self._cc = np.zeros((0, 2), dtype=np.uint8)
        cc = path + ".cc608"
        if os.path.exists(cc):
            raw = np.fromfile(cc, dtype=np.uint8)
            self._cc = raw[: len(raw) // 2 * 2].reshape(-1, 2)

    def read_video(self, frame_no: int) -> np.ndarray:
        fn = min(frame_no, self.n_frames - 1)
        if self._cache is not None and self._cache[0] == fn:
            return self._cache[1]
        self._f.seek(fn * self._frame_bytes)
        raw = np.frombuffer(self._f.read(self._frame_bytes),
                            dtype=np.uint32).reshape(self.height, self.width)
        rgb = np.empty((self.height, self.width, 3), dtype=np.uint8)
        rgb[..., 0] = (raw >> 16) & 0xFF
        rgb[..., 1] = (raw >> 8) & 0xFF
        rgb[..., 2] = raw & 0xFF
        self._cache = (fn, rgb)
        return rgb

    def read_audio(self, start: int, count: int) -> np.ndarray:
        out = np.zeros((count, 2), dtype=np.int16)
        got = self._audio[start:start + count]
        out[:len(got)] = got
        return out

    def eof(self, frame_no: int) -> bool:
        return frame_no >= self.n_frames

    def close(self) -> None:
        self._f.close()

    def read_cc608(self, frame_no: int):
        """EIA-608 byte pair for frame_no (0, 0) when none)."""
        if frame_no < len(self._cc):
            return int(self._cc[frame_no, 0]), int(self._cc[frame_no, 1])
        return 0, 0
