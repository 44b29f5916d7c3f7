"""DANCE / BS digital-subcarrier audio encoder (ITU-R BO.650); a copy of
hacktv_tpu/audio/dance.py (numpy only).

Bit-exact re-implementation of the reference encoder
(src/dance.c:54-351): 50/10 us pre-emphasis (fixed int16 taps at
32 kHz), 8-range near-instantaneous companding to 10 bits, BCH(63,56)
block codes, 63-step full-frame interleave, 10-bit PRN whitening, and
the 1024 kbaud DQPSK symbol stream (src/dance.c:444-518) that shares
its differential mapping and pulse shaping with NICAM-728.

The waveform synthesis happens on the device through the same
pulse-matrix machinery as NICAM (audio/synth.py); this module produces
frame bytes and per-symbol I/Q signs.  Only mode A (4x 32 kHz
companded channels, 2 in use) is generated, matching the reference's
runtime wiring (src/dance.c:479-484).
"""

from __future__ import annotations

import numpy as np

DANCE_BIT_RATE = 2_048_000
DANCE_SYMBOL_RATE = DANCE_BIT_RATE // 2
DANCE_FRAME_BITS = 2048
DANCE_FRAME_BYTES = DANCE_FRAME_BITS // 8
DANCE_FRAME_SYMS = DANCE_FRAME_BITS // 2
DANCE_A_AUDIO_LEN = 32          # stereo pairs per frame at 32 kHz

# 50/10 us pre-emphasis, 32 kHz, mode A (src/dance.c:38-44)
PRE_A_TAPS = np.array([
    1, -1, 1, -1, 1, -1, 1, -1, 1, -1, 1, -1, 1, -1, 1, -1, 2, -2, 2, -2, 2,
    -3, 3, -3, 4, -5, 5, -6, 7, -10, 10, -19, 11, -55, -24, -298, -635,
    -4106, 20126, -4106, -635, -298, -24, -55, 11, -19, 10, -10, 7, -6, 5,
    -5, 4, -3, 3, -3, 2, -2, 2, -2, 2, -1, 1, -1, 1, -1, 1, -1, 1, -1, 1,
    -1, 1, -1, 1, -1, 1], dtype=np.int64)
PRE_A_NTAPS = len(PRE_A_TAPS)

# companding ranges (src/dance.c:65-74): index -> (pattern, shift); the
# mask test is equivalent to a bit-length threshold (see range_indices)
_RANGE_PATTERN = np.array([0x00, 0x9C, 0x4E, 0xD2, 0x3A, 0xA6, 0x74, 0xE8],
                          dtype=np.int64)
_RANGE_SHIFT = np.array([6, 5, 4, 3, 2, 2, 2, 2], dtype=np.int64)


def prn_sequence() -> np.ndarray:
    """10-bit LFSR whitening bytes (src/dance.c:76-95); bytes 0-1 are
    zero (the 0x135E sync word is sent clear)."""
    poly = 0x3FF
    out = np.zeros(DANCE_FRAME_BYTES, dtype=np.uint8)
    for x in range(2, DANCE_FRAME_BYTES):
        v = 0
        for _ in range(8):
            b = poly & 1
            v = ((v << 1) | b) & 0xFF
            b ^= (poly >> 3) & 1
            poly = (poly >> 1) | (b << 9)
        out[x] = v
    return out


_PRN = prn_sequence()


def _interleave_perm() -> np.ndarray:
    """Permutation over the 2016 block bits: out bit x reads in bit y,
    y stepping 63 with the reference's exact wrap (src/dance.c:97-112)."""
    perm = np.zeros(DANCE_FRAME_BITS - 32, dtype=np.int64)
    y = 0
    for x in range(DANCE_FRAME_BITS - 32):
        perm[x] = y
        y += 63
        if y >= 2016:
            y -= 2015
    return perm


_ILEAVE = _interleave_perm()


def _bch_masks() -> np.ndarray:
    """BCH(63,56) is linear: the 7 parity bits are the XOR of per-input-
    bit code masks.  Derive mask i by running the reference's shift
    register (src/dance.c:196-213) on a unit vector."""
    masks = np.zeros(56, dtype=np.int64)
    for i in range(56):
        code = 0
        for j in range(56):
            b = ((1 if j == i else 0) ^ code) & 1
            code >>= 1
            if b:
                code ^= 0x51
        masks[i] = code
    return masks


_BCH_MASKS = _bch_masks()


def _wrap16(x: np.ndarray) -> np.ndarray:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def pre_emphasis(pcm: np.ndarray) -> np.ndarray:
    """Causal pre-emphasis FIR with int16 wrap on output: out[n] =
    (sum_j x[n-76+j] * taps[j]) >> 15 assigned to int16_t
    (src/dance.c:132-152)."""
    x = np.asarray(pcm, dtype=np.int64)
    acc = np.convolve(x, PRE_A_TAPS[::-1])[:len(x)]
    return _wrap16(acc >> 15)


def range_indices(blocks: np.ndarray) -> np.ndarray:
    """Companding range per 32-sample block (src/dance.c:114-130):
    blocks [n, 32] -> [n].  The scan is equivalent to the largest b with
    max(positive-ised sample) < 2^(15-b); silence keeps b = 7."""
    s = np.where(blocks < 0, ~blocks, blocks).astype(np.int64)
    m = np.max(s, axis=-1)
    bl = np.zeros_like(m)
    v = m.copy()
    for shift in (8, 4, 2, 1):
        hit = v >= (1 << shift)
        bl += np.where(hit, shift, 0)
        v = np.where(hit, v >> shift, v)
    bl += (m > 0)
    return 7 - np.clip(bl - 8, 0, 7)


def encode_frames(pre_lr: np.ndarray, first_frame_idx: int) -> np.ndarray:
    """Encode consecutive mode-A DANCE frames.

    pre_lr: int array [(n_frames+1)*32, 2] of **pre-emphasised** L/R
    samples: row block c (32 rows) is the audio input of encode call
    first_frame_idx - 1 + c... i.e. the first 32 rows are the block of
    the PREVIOUS call (whose samples are this frame's payload,
    src/dance.c:229-231 double buffering) and each following block c
    belongs to frame first_frame_idx + c - 1's call.  For frame 0 the
    previous call does not exist; pass zeros (the frames[] buffers start
    zeroed).

    Returns frame bytes [n_frames, 256] (uint8).
    """
    pre = np.asarray(pre_lr, dtype=np.int64)
    n_frames = len(pre) // DANCE_A_AUDIO_LEN - 1
    blocks = pre.reshape(n_frames + 1, DANCE_A_AUDIO_LEN, 2)

    # range index per call and channel; channels 3/4 are silent -> 7
    rl = range_indices(blocks[..., 0])       # [n_frames+1]
    rr = range_indices(blocks[..., 1])

    frame_bits = np.zeros((n_frames, DANCE_FRAME_BITS), dtype=np.uint8)

    # header (src/dance.c:234-239): sync 0x135E, mode A, stereo 1/2,
    # none 3/4, unmuted
    hdr = np.array([0x13, 0x5E, (0x00 << 7) | (0x00 << 5) | (0x03 << 3),
                    0x00], dtype=np.uint8)
    frame_bits[:, :32] = np.unpackbits(hdr)[None, :]

    blk = frame_bits[:, 32:].reshape(n_frames, 32, 63)

    # bit 0 of block i: bit (7 - (i & 7)) of channel (i >> 3)'s range
    # pattern for THIS call (src/dance.c:252-255)
    pat = np.stack([_RANGE_PATTERN[rl[1:]], _RANGE_PATTERN[rr[1:]],
                    np.full(n_frames, 0xE8, dtype=np.int64),
                    np.full(n_frames, 0xE8, dtype=np.int64)], axis=1)
    i = np.arange(32)
    blk[:, :, 0] = (pat[:, i >> 3] >> (7 - (i & 7))[None, :]) & 1

    # bits 1..40: 4 channels x 10 bits MSB-first from the PREVIOUS call,
    # shifted by that call's ranges (src/dance.c:257-261)
    sh_l = _RANGE_SHIFT[rl[:-1]][:, None]
    sh_r = _RANGE_SHIFT[rr[:-1]][:, None]
    vl = (blocks[:-1, :, 0] >> sh_l) & 0x3FF    # [n_frames, 32]
    vr = (blocks[:-1, :, 1] >> sh_r) & 0x3FF
    b10 = np.arange(9, -1, -1)
    blk[:, :, 1:11] = (vl[:, :, None] >> b10[None, None, :]) & 1
    blk[:, :, 11:21] = (vr[:, :, None] >> b10[None, None, :]) & 1
    # channels 3/4 and the 15 additional-data bits stay zero

    # BCH(63,56) parity into bits 56..62, LSB first (src/dance.c:196-213)
    contrib = np.where(blk[:, :, :56].astype(bool), _BCH_MASKS[None, None, :], 0)
    code = np.bitwise_xor.reduce(contrib, axis=2)
    blk[:, :, 56:] = (code[:, :, None] >> np.arange(7)[None, None, :]) & 1

    # interleave + PRN
    frame_bits[:, 32:] = frame_bits[:, 32:][:, _ILEAVE]
    packed = np.packbits(frame_bits, axis=1)
    packed ^= _PRN[None, :]
    return packed


DANCE_B_AUDIO_LEN = 48          # stereo pairs per frame at 48 kHz

# 50/10 us pre-emphasis, 48 kHz, mode B (src/dance.c:46-56)
PRE_B_TAPS = np.array([
    -1, 1, -1, 1, -1, 1, -1, 1, -1, 1, -1, 1, -2, 2, -2, 2, -3, 2, -6, 1,
    -12, -5, -32, -34, -115, -193, -583, -1324, -4359, 23207, -4359,
    -1324, -583, -193, -115, -34, -32, -5, -12, 1, -6, 2, -3, 2, -2, 2,
    -2, 1, -1, 1, -1, 1, -1, 1, -1, 1, -1, 1, -1], dtype=np.int64)


def pre_emphasis_b(pcm: np.ndarray) -> np.ndarray:
    """Mode-B pre-emphasis at 48 kHz (src/dance.c:283-318)."""
    x = np.asarray(pcm, dtype=np.int64)
    acc = np.convolve(x, PRE_B_TAPS[::-1])[:len(x)]
    return _wrap16(acc >> 15)


def encode_frames_b(pre_lr: np.ndarray, first_frame_idx: int
                    ) -> np.ndarray:
    """Encode consecutive mode-B DANCE frames (2x 48 kHz 16-bit linear
    channels, src/dance.c:283-351; present in the reference but not
    wired to its runtime, which only emits mode A from dance.c:479).

    pre_lr: [(n_frames+1)*48, 2] **pre-emphasised** L/R samples with
    the same one-call double-buffer offset as mode A.
    """
    pre = np.asarray(pre_lr, dtype=np.int64)
    n_frames = len(pre) // DANCE_B_AUDIO_LEN - 1
    blocks = pre.reshape(n_frames + 1, DANCE_B_AUDIO_LEN, 2)

    rl = range_indices(blocks[..., 0])
    rr = range_indices(blocks[..., 1])

    frame_bits = np.zeros((n_frames, DANCE_FRAME_BITS), dtype=np.uint8)
    # header: sync 0x135E, mode B, stereo 1/2, none 3/4, unmuted
    hdr = np.array([0x13, 0x5E, (0x01 << 7) | (0x00 << 5) | (0x03 << 3),
                    0x00], dtype=np.uint8)
    frame_bits[:, :32] = np.unpackbits(hdr)[None, :]

    blk = frame_bits[:, 32:].reshape(n_frames, 32, 63)
    # range-code bit per block: channels 1/2 use their real companding
    # pattern (even though the samples are linear), 3/4 pattern 0x00
    pat = np.stack([_RANGE_PATTERN[rl[1:]], _RANGE_PATTERN[rr[1:]],
                    np.zeros(n_frames, dtype=np.int64),
                    np.zeros(n_frames, dtype=np.int64)], axis=1)
    i = np.arange(32)
    blk[:, :, 0] = (pat[:, i >> 3] >> (7 - (i & 7))[None, :]) & 1

    # 3 x 16-bit linear samples per block from the PREVIOUS call:
    # global sample slot sa = 3*i + c selects channel sa&1, row sa>>1
    sa = (3 * i[:, None] + np.arange(3)[None, :]).reshape(-1)  # [96]
    v = blocks[:-1, sa >> 1, sa & 1] & 0xFFFF        # [n_frames, 96]
    b16 = np.arange(15, -1, -1)
    bits = ((v[:, :, None] >> b16[None, None, :]) & 1).astype(np.uint8)
    blk[:, :, 1:49] = bits.reshape(n_frames, 32, 48)
    # 7 additional-data bits stay zero

    contrib = np.where(blk[:, :, :56].astype(bool),
                       _BCH_MASKS[None, None, :], 0)
    code = np.bitwise_xor.reduce(contrib, axis=2)
    blk[:, :, 56:] = (code[:, :, None] >> np.arange(7)[None, None, :]) & 1

    frame_bits[:, 32:] = frame_bits[:, 32:][:, _ILEAVE]
    packed = np.packbits(frame_bits, axis=1)
    packed ^= _PRN[None, :]
    return packed


def frame_symbols(frames: np.ndarray) -> np.ndarray:
    """2-bit symbols from frame bytes, MSB-first pairs
    (src/dance.c:489)."""
    bits = np.unpackbits(frames.reshape(-1, DANCE_FRAME_BYTES), axis=1)
    pairs = bits.reshape(frames.shape[0], DANCE_FRAME_SYMS, 2)
    return (pairs[..., 0] << 1 | pairs[..., 1]).astype(np.int64)
