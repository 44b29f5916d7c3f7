"""Built-in test pattern + ident tone source.

Reproduces the reference's test card pixel-for-pixel (src/av_test.c:71-205):
75% colour bars, red strip, grey gradient, 8-level grey staircase, logo
overlay, and the BBC-1-style 1 kHz ident tone (left/right interruptions).
All integer arithmetic matches the C expressions.
"""

from __future__ import annotations

import numpy as np

_LOGO_WIDTH = 48
_LOGO_HEIGHT = 9
_LOGO_SCALE = 4
_LOGO = (
    "                                                "
    " ##  ##    ##     ####   ##  ##  ######  ##  ## "
    " ##  ##   ####   ##  ##  ## ##     ##    ##  ## "
    " ##  ##  ##  ##  ##      ####      ##    ##  ## "
    " ######  ######  ##      ###       ##    ##  ## "
    " ##  ##  ##  ##  ##      ####      ##    ##  ## "
    " ##  ##  ##  ##  ##  ##  ## ##     ##     ####  "
    " ##  ##  ##  ##   ####   ##  ##    ##      ##   "
    "                                                "
)

_BARS = [0x000000, 0x0000BF, 0xBF0000, 0xBF00BF,
         0x00BF00, 0x00BFBF, 0xBFBF00, 0xFFFFFF]


def test_card_rgb(width: int, height: int) -> np.ndarray:
    """Return the test pattern as uint8 [height, width, 3] (R, G, B)."""
    img = np.zeros((height, width), dtype=np.uint32)
    x = np.arange(width)

    bars = np.array(_BARS, dtype=np.uint32)[7 - x * 8 // width]
    grad = x * 0xFF // (width - 1)
    grad_rgb = (grad << 16) | (grad << 8) | grad
    stair = grad & 0xE0
    stair = stair | (stair >> 3) | (stair >> 6)
    stair_rgb = (stair << 16) | (stair << 8) | stair

    for y in range(height):
        if y < height - 140:
            img[y] = bars
        elif y < height - 120:
            img[y] = 0xBF0000
        elif y < height - 100:
            img[y] = grad_rgb
        else:
            img[y] = stair_rgb

    # Logo overlay (src/av_test.c:139-154)
    if width >= _LOGO_WIDTH * _LOGO_SCALE and height >= _LOGO_HEIGHT * _LOGO_SCALE:
        x0 = (width - _LOGO_WIDTH * _LOGO_SCALE) // 2
        y0 = height // 10
        for ly in range(_LOGO_HEIGHT * _LOGO_SCALE):
            row = _LOGO[ly // _LOGO_SCALE * _LOGO_WIDTH:
                        (ly // _LOGO_SCALE + 1) * _LOGO_WIDTH]
            for lx in range(_LOGO_WIDTH * _LOGO_SCALE):
                img[y0 + ly, x0 + lx] = (0x000000 if row[lx // _LOGO_SCALE] == ' '
                                         else 0xFFFFFF)

    out = np.empty((height, width, 3), dtype=np.uint8)
    out[..., 0] = (img >> 16) & 0xFF
    out[..., 1] = (img >> 8) & 0xFF
    out[..., 2] = img & 0xFF
    return out


def test_tone(sample_rate_num: int = 32000, sample_rate_den: int = 1
              ) -> np.ndarray:
    """1 kHz ident tone, int16 stereo [n, 2] (src/av_test.c:156-196)."""
    d = 1000.0 * 2.0 * np.pi * sample_rate_den / sample_rate_num
    y = sample_rate_num // sample_rate_den * 64 // 100  # 640 ms
    n = y * 10
    x = np.arange(n)
    tone = (np.sin(x * d) * 32767 * 0.1).astype(np.int16)
    left = tone.copy()
    right = tone.copy()
    left[:y] = 0                  # 0-640 ms: left muted
    right[2 * y:3 * y] = 0        # 1280-1920 ms: right muted
    right[4 * y:5 * y] = 0        # 2560-3200 ms: right muted again
    return np.stack([left, right], axis=1)


class TestCardSource:
    """AV source yielding the constant test card frame + looping tone."""

    stateless = True       # index-addressable: checkpoint-safe

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.rgb = test_card_rgb(width, height)
        self.audio = test_tone()
        self.interlaced = 0

    def read_video(self, frame_no: int) -> np.ndarray:
        return self.rgb

    def read_audio(self, start: int, count: int) -> np.ndarray:
        """Loop the ident tone forever; absolute sample addressing.
        Built from contiguous slices (a modulo fancy-index gather costs
        ~0.3 ms per 41k-pair block and was a top host hot-spot).

        The returned array may be a read-only VIEW of the tone buffer —
        callers must not mutate it in place (all current consumers
        copy)."""
        n = self.audio.shape[0]
        s = start % n
        if s + count <= n:
            out = self.audio[s:s + count]
            out.flags.writeable = False
            return out
        parts = [self.audio[s:]]
        remaining = count - (n - s)
        if remaining >= n:
            parts.append(np.tile(self.audio, (remaining // n, 1)))
        if remaining % n:
            parts.append(self.audio[:remaining % n])
        return np.concatenate(parts)

    def eof(self, frame_no: int) -> bool:
        return False
