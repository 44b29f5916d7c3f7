"""The port's S/PDIF block encoder (audio/spdif.py) against the JAX
package's and against a direct transcription of the reference
(src/spdif.c:27-82), on seeded PCM, on silence and at full scale.
Tolerance: none, the blocks are compared byte for byte."""

from __future__ import annotations

import numpy as np
import pytest

from hacktv_tpu.audio import spdif as jsp
from hacktv_tpu_torch.audio import spdif as tsp


def _subframe_scalar(sample, pcm, c):
    sf = (pcm & 0xFFFF) << 12
    sf |= (c & 1) << 30
    for i in range(31):
        sf ^= ((sf >> i) & 1) << 31
    out = bytearray(8)
    out[0] = 0xE4 if sample & 1 else (0xE2 if sample else 0xE8)
    p = 1
    for i in range(4, 32):
        out[i >> 2] |= p << (7 - ((i & 3) << 1))
        p ^= (sf >> i) & 1
        out[i >> 2] |= p << (6 - ((i & 3) << 1))
        p ^= 1
    return bytes(out)


def _block_scalar(pcm):
    cs = bytearray(24)
    cs[0] = 1 << 5
    out = bytearray()
    for i in range(384):
        c = (cs[i >> 4] >> (7 - ((i >> 1) & 7))) & 1
        out += _subframe_scalar(i, int(pcm[i]) & 0xFFFF, c)
    return bytes(out)


PCM = {"seeded": np.random.default_rng(42).integers(
           -32768, 32768, 384).astype(np.int16),
       "silence": np.zeros(384, np.int16),
       "full-scale": np.tile(np.array([32767, -32768], np.int16), 192)}


@pytest.mark.parametrize("name", list(PCM))
def test_spdif_block_matches_jax(name):
    pcm = PCM[name]
    got = tsp.spdif_block(pcm)
    ref = jsp.spdif_block(pcm)
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape == (tsp.SPDIF_BLOCK_BYTES,)
    assert got.tobytes() == ref.tobytes()
    assert got.tobytes() == _block_scalar(pcm)


def test_spdif_constants():
    assert tsp.SPDIF_BLOCK_SAMPLES == jsp.SPDIF_BLOCK_SAMPLES == 384
    assert tsp.SPDIF_BLOCK_BYTES == jsp.SPDIF_BLOCK_BYTES
    for rate in (32000, 44100, 48000):
        assert tsp.bitrate(rate) == jsp.bitrate(rate) == rate * 128
