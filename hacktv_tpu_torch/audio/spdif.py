"""S/PDIF (consumer) biphase-mark block encoder.

Port of hacktv_tpu/audio/spdif.py, numpy only.  Bit-exact
re-implementation of src/spdif.c:27-82: 192-frame blocks of
two 32-bit subframes (aux + 16-bit PCM + V/U/C + even parity), BMC
encoded MSB-first with B/M/W preambles.  Used by the fl2k sink's blue
channel (src/rf_fl2k.c:192-248).  Fully vectorised: a block is one
[384, 32] bit matrix -> parity via XOR-reduce, biphase via cumulative
XOR along the bit axis.
"""

from __future__ import annotations

import numpy as np

SPDIF_BLOCK_SAMPLES = 384          # 192 frames x 2 channels
SPDIF_BLOCK_BYTES = SPDIF_BLOCK_SAMPLES * 8


def bitrate(sample_rate: int) -> int:
    return sample_rate * 128


def _channel_status() -> np.ndarray:
    cs = np.zeros(24, dtype=np.uint8)
    cs[0] = 1 << 5          # consumer, normal, copy permit, 2ch, no pre-emph
    return cs


def spdif_block(pcm: np.ndarray) -> np.ndarray:
    """Encode one block: pcm int16 [384] (L/R interleaved) -> uint8
    [3072] biphase bytes."""
    pcm = np.asarray(pcm, dtype=np.int64) & 0xFFFF
    i = np.arange(SPDIF_BLOCK_SAMPLES)
    cs = _channel_status()
    c = (cs[i >> 4] >> (7 - ((i >> 1) & 7))) & 1

    sf = (pcm << 12) | (c.astype(np.int64) << 30)
    # even parity over bits 0..30 into bit 31 (src/spdif.c:40-43)
    t = sf & 0x7FFFFFFF
    for sh in (16, 8, 4, 2, 1):
        t ^= t >> sh
    sf |= (t & 1) << 31

    # subframe bits 4..31, MSB-irrelevant: the stream sends bit index
    # order 4,5,...,31 with biphase-mark (two half-bits per bit)
    bits = (sf[:, None] >> np.arange(4, 32)[None, :]) & 1   # [384, 28]

    # biphase: p starts 1 each subframe; first half-bit = p, then
    # p ^= bit; second half-bit = p, then p ^= 1
    # half-bit stream h[2k] = p_k, h[2k+1] = p_k ^ bit_k,
    # p_{k+1} = p_k ^ bit_k ^ 1
    # p_{k+1} = 1 ^ parity(bits[0..k]) ^ ((k+1) & 1)
    pk = (1 ^ np.cumsum(bits, axis=1) ^
          (np.arange(1, 29)[None, :] & 1)) & 1
    p_before = np.concatenate(
        [np.ones((SPDIF_BLOCK_SAMPLES, 1), dtype=np.int64), pk[:, :-1]],
        axis=1) & 1
    h1 = p_before
    h2 = p_before ^ bits

    out = np.zeros((SPDIF_BLOCK_SAMPLES, 8), dtype=np.uint8)
    # preamble byte (bits 0..3 -> two half-bits each, packed 2/bit):
    # B=0xE8 (block start), M=0xE2 (left), W=0xE4 (right)
    pre = np.where(i & 1, 0xE4, np.where(i == 0, 0xE8, 0xE2))
    out[:, 0] = pre
    # pack half-bits: bit j (j=4..31) -> byte j>>2, bits (7-((j&3)<<1))
    j = np.arange(4, 32)
    byte_idx = j >> 2
    sh1 = 7 - ((j & 3) << 1)
    sh2 = 6 - ((j & 3) << 1)
    vals = (h1 << sh1[None, :]) | (h2 << sh2[None, :])
    for b in range(1, 8):
        sel = byte_idx == b
        out[:, b] = np.bitwise_or.reduce(
            vals[:, sel].astype(np.uint8), axis=1)
    return out.reshape(-1)
