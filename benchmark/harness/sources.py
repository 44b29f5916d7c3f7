"""The traffic generator: one AV source per traffic mix, built from the
mix's parameters and the run's seed.  Kinds:

  testcard  the test card picture (the caller's `test_card_rgb`) at the
            mode's active geometry, with seeded noise as its sound
"""

from __future__ import annotations

import numpy as np


class NoiseCard:
    """A fixed picture with seeded stereo noise as its sound, served by
    absolute pair index from a buffer whose length (`pairs`, odd) is
    coprime with the blocks' sound windows, so that no two blocks of a
    run carry the same sound.  Index-addressable, as the test card is."""

    stateless = True

    def __init__(self, rgb: np.ndarray, seed: int, low: int, high: int,
                 pairs: int):
        self.rgb = rgb
        self.height, self.width = rgb.shape[:2]
        self.interlaced = 0
        rng = np.random.default_rng([int(seed) & (2**63 - 1), 1])
        self.audio = rng.integers(low, high, (pairs, 2)).astype(np.int16)

    def read_video(self, frame_no: int) -> np.ndarray:
        return self.rgb

    def read_audio(self, start: int, count: int) -> np.ndarray:
        n = len(self.audio)
        s = start % n
        if s + count <= n:
            return self.audio[s:s + count]
        parts, left = [self.audio[s:]], count - (n - s)
        while left > 0:
            parts.append(self.audio[:min(left, n)])
            left -= n
        return np.concatenate(parts)

    def eof(self, frame_no: int) -> bool:
        return False


def make_source(mix: dict, seed: int, width: int, height: int,
                test_card_rgb):
    """The source of traffic mix `mix` for a picture of width x height;
    `test_card_rgb(width, height)` draws the test card (each side of the
    comparison passes its own)."""
    kind = mix["kind"]
    if kind == "testcard":
        a = mix["audio"]
        return NoiseCard(test_card_rgb(width, height), seed, a["low"],
                         a["high"], a["pairs"])
    raise ValueError(f"unknown traffic kind {kind!r}")
