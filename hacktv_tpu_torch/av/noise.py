"""Test card with seeded noise for sound: a source whose audio changes
every block, for tests and measurements that must not see a repeating
tone.  The noise is made once, from the seed, with numpy."""

from __future__ import annotations

import numpy as np

from .testcard import TestCardSource


class NoiseSource(TestCardSource):
    """The static test card, with int16 stereo noise in [-20000, 20000)
    from `np.random.default_rng(seed)` as its audio, looping every
    `seconds` seconds."""

    def __init__(self, width: int, height: int, seed: int = 11,
                 seconds: int = 120):
        super().__init__(width, height)
        self.noise = np.random.default_rng(seed).integers(
            -20000, 20000, (seconds * 32000, 2)).astype(np.int16)

    def read_audio(self, start: int, count: int) -> np.ndarray:
        n = len(self.noise)
        i = start % n
        if i + count <= n:
            return self.noise[i:i + count]
        return np.concatenate([self.noise[i:],
                               self.noise[:i + count - n]])


class MovingNoiseSource(NoiseSource):
    """NoiseSource with a moving picture: `nframes` distinct RGB frames
    (a gradient shifted 40 pixels a frame, with seeded noise), cycling."""

    def __init__(self, width: int, height: int, seed: int = 11,
                 seconds: int = 4, nframes: int = 3):
        super().__init__(width, height, seed, seconds)
        rng = np.random.default_rng(seed + 1)
        x = np.arange(width)[None, :, None]
        y = np.arange(height)[:, None, None]
        self.frames = [
            np.clip((x + 40 * f) % 256 * np.array([1, 0.5, 0.25])
                    + (y % 64) + rng.integers(0, 24, (height, width, 3)),
                    0, 255).astype(np.uint8) for f in range(nframes)]

    def read_video(self, frame_no: int) -> np.ndarray:
        return self.frames[frame_no % len(self.frames)]
