"""DANCE, the BS digital sound of ntsc-bs, against hacktv_tpu on the CPU,
byte for byte: every function of audio/dance.py on seeded PCM, the
chain's frames 0-99 and their differential signs, Encoder("ntsc-bs")
over one-frame blocks 0-2 and two-frame blocks 0-1, the statics carried
over from the JAX encoder (convert.py), and DANCE's pulse product, whose
13-bit taps run as two exact parts (synth.split_pulse): held against the
plain f64 product and against the JAX package's nicam_add, with NICAM's
product left as it was (its own numbers, one bmm)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu.audio import chain as jchain
from hacktv_tpu.audio import dance as jdance
from hacktv_tpu.audio import synth as jsynth
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import convert
from hacktv_tpu_torch.audio import chain as tchain
from hacktv_tpu_torch.audio import dance as tdance
from hacktv_tpu_torch.audio import synth as tsynth
from hacktv_tpu_torch.av.noise import NoiseSource
from hacktv_tpu_torch.config import get_mode

RATE = 16_000_000


def _pcm(n, seed, lo=-32768, hi=32768):
    return np.random.default_rng(seed).integers(lo, hi, n).astype(np.int64)


@pytest.mark.parametrize("name", ["_PRN", "_ILEAVE", "_BCH_MASKS",
                                  "PRE_A_TAPS", "PRE_B_TAPS",
                                  "_RANGE_PATTERN", "_RANGE_SHIFT"])
def test_tables_match_jax(name):
    tc.assert_same(getattr(tdance, name), getattr(jdance, name), name)


def test_table_functions_match_jax():
    tc.assert_same(tdance.prn_sequence(), jdance.prn_sequence(), "prn")
    tc.assert_same(tdance._interleave_perm(), jdance._interleave_perm(),
                   "interleave")
    tc.assert_same(tdance._bch_masks(), jdance._bch_masks(), "bch")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pre_emphasis_matches_jax(seed):
    x = _pcm(4096, seed)
    tc.assert_same(tdance.pre_emphasis(x), jdance.pre_emphasis(x), "pre_a")
    tc.assert_same(tdance.pre_emphasis_b(x), jdance.pre_emphasis_b(x),
                   "pre_b")


def test_range_indices_match_jax():
    """Seeded blocks at every level, silence and the int16 extremes."""
    rng = np.random.default_rng(7)
    scale = 2 ** rng.integers(0, 16, (400, 1))
    blocks = (rng.integers(-32768, 32768, (400, 32)) * scale // 32768)
    blocks[0] = 0
    blocks[1] = -32768
    blocks[2] = 32767
    tc.assert_same(tdance.range_indices(blocks),
                   jdance.range_indices(blocks), "ranges")


@pytest.mark.parametrize("seed", [3, 4])
def test_encode_frames_match_jax(seed):
    rng = np.random.default_rng(seed)
    quiet = rng.integers(-300, 300, (33 * 32, 2))
    loud = rng.integers(-32768, 32768, (33 * 32, 2))
    pre = np.where(rng.random((33 * 32, 1)) < 0.5, quiet, loud)
    a = tdance.encode_frames(pre, 5)
    tc.assert_same(a, jdance.encode_frames(pre, 5), "mode A")
    tc.assert_same(tdance.frame_symbols(a), jdance.frame_symbols(a),
                   "symbols")
    pre_b = rng.integers(-32768, 32768, (9 * 48, 2))
    tc.assert_same(tdance.encode_frames_b(pre_b, 1),
                   jdance.encode_frames_b(pre_b, 1), "mode B")


def _chains():
    p = TEncoder("ntsc-bs", RATE, device="cpu").params
    src = NoiseSource(p.active_width, p.conf.active_lines, seed=11)
    conf = get_mode("ntsc-bs")
    return (tchain.AudioChain(conf, RATE, p.width, src),
            jchain.AudioChain(conf, RATE, p.width, src))


def test_chain_frames_and_signs_match_jax():
    """The chain's DANCE frames 0-99 (the audio block each frame's encode
    sees, the double buffer, the pre-emphasis history), then the signs of
    frames 40-60 through the anchor, and the anchor itself."""
    t, j = _chains()
    tc.assert_same(t.dance["num"], j.dance["num"], "num")
    tc.assert_same(t.dance["den"], j.dance["den"], "den")
    tc.assert_same(t.dance["taps"], j.dance["taps"], "taps")
    tc.assert_same(t._dance_frames(0, 100), j._dance_frames(0, 100),
                   "frames 0-99")
    tc.assert_same(t._dance_frames(37, 52), j._dance_frames(37, 52),
                   "frames 37-51")
    for f0, f1 in ((0, 20), (18, 40), (40, 61)):
        tc.assert_same(t._dance_signs(f0, f1), j._dance_signs(f0, f1),
                       f"signs {f0}-{f1}")
        assert t._dance_dsym_anchor == j._dance_dsym_anchor


def _encoders(fpb=1):
    p = TEncoder("ntsc-bs", RATE, device="cpu").params
    src = NoiseSource(p.active_width, p.conf.active_lines, seed=5)
    tc.jax_runtime()
    j = JEncoder("ntsc-bs", RATE, source=src, frames_per_block=fpb)
    t = TEncoder("ntsc-bs", RATE, source=src, frames_per_block=fpb,
                 device="cpu")
    assert t._spill_warmup == j._spill_warmup
    assert t.fm_video_exact is not None and j.fm_video_exact is not None
    return j, t


def _check(j, t, blocks, name):
    for b in blocks:
        ref, got = j.encode_block(b), t.encode_block(b)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        snr, maxerr, ndiff = tc.error_report(got, ref)
        assert ndiff == 0, (f"{name} block {b}: {ndiff} of {ref.size} "
                            f"differ, max {maxerr}, {snr:.1f} dB")


def test_ntsc_bs_encoder_matches_jax():
    """FM video with DANCE at 16 MS/s (W = 1017, 79 taps, P = 125),
    one-frame blocks 0-2."""
    j, t = _encoders()
    _check(j, t, range(3), "ntsc-bs")


def test_ntsc_bs_two_frame_blocks_match_jax():
    j, t = _encoders(fpb=2)
    _check(j, t, range(2), "ntsc-bs (2 frames)")


def test_dance_statics_carry_over():
    """DANCE's pulse matrices and LUTs, taken from the JAX encoder as
    numpy under convert.py's names and installed on a port encoder, give
    the JAX encoder's bytes."""
    j, t = _encoders()
    arrays = convert.statics_to_numpy(t)
    want = {"dance_statics." + f: np.asarray(getattr(j.dance_statics, f))
            for f in ("pulse", "lut_i", "lut_q")}
    tc.assert_same({k: arrays[k] for k in want}, want, "dance statics")
    _, other = _encoders()
    convert.statics_from_numpy(other, {**arrays, **want})
    tc.assert_same(convert.statics_to_numpy(other), arrays, "installed")
    assert other.dance_statics.pulse_hi is not None
    _check(j, other, range(2), "ntsc-bs (carried)")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 11 significant bits (round to nearest even)."""
    b = x.to(torch.float32).view(torch.int32)
    r = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


def _dqpsk_inputs(st, seed):
    """A seeded sign stream and window offsets for a block of 525 lines."""
    rng = np.random.default_rng(seed)
    G = -(-525 // st.period)
    L = (G + 4) * st.syms_per_period
    si, sq = (torch.as_tensor(rng.choice([-1.0, 0.0, 1.0], L).astype(
        np.float32)) for _ in range(2))
    offq = rng.integers(0, 3, st.period).astype(np.int32)
    offr = rng.integers(0, st.syms_per_period, st.period).astype(np.int32)
    cc = torch.as_tensor(rng.integers(0, st.den, 525).astype(np.int32))
    return si, sq, offq, offr, cc


def _dance_encoder():
    return TEncoder("ntsc-bs", RATE, device="cpu")


def test_dance_product_is_split_exactly():
    """DANCE's taps need 13 bits (|5,605| at 16 MS/s); the two parts each
    fit TF32's 11 bits unchanged, while the taps themselves do not, and
    64 * hi + lo gives the taps back."""
    t = _dance_encoder()
    st = t.dance_statics
    pulse = st.pulse
    assert pulse.abs().max() >= tsynth.EXACT_TAP
    assert int(pulse.abs().max()) == 5605
    hi, lo = st.pulse_hi, st.pulse_lo
    assert torch.equal(hi * tsynth.PULSE_SPLIT + lo, pulse)
    assert max(hi.abs().max(), lo.abs().max()) < tsynth.EXACT_TAP
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert not torch.equal(_tf32(pulse), pulse)


@pytest.mark.parametrize("seed", [0, 1])
def test_dance_product_matches_f64_and_jax(seed):
    """nicam_add with DANCE's statics equals the same mix over the plain
    f64 product, and the JAX package's nicam_add, on seeded signs."""
    t = _dance_encoder()
    st = t.dance_statics
    si, sq, offq, offr, cc = _dqpsk_inputs(st, seed)
    k0 = seed * 7 % st.period
    zero = torch.zeros((525, t.params.width))
    gi, gq = tsynth.nicam_add(st, zero, zero, si, sq, offq, offr, cc, k0)

    plain = tsynth.NicamStatics(
        pulse=st.pulse.double(), lut_i=st.lut_i, lut_q=st.lut_q, den=st.den,
        period=st.period, nslot=st.nslot, kf=st.kf,
        syms_per_period=st.syms_per_period)
    z64 = zero.double()
    ri, rq = tsynth.nicam_add(plain, z64, z64, si.double(), sq.double(),
                              offq, offr, cc, k0)
    assert torch.equal(gi, ri.float()) and torch.equal(gq, rq.float())

    js = jsynth.make_nicam_statics(*(t.audio.dance[k] for k in (
        "taps", "num", "den")), t.params.width, t.audio.dance["timing"])
    ji, jq = jsynth.nicam_add(js, zero.numpy(), zero.numpy(), si.numpy(),
                              sq.numpy(), offq, offr, cc.numpy(), k0)
    assert np.array_equal(gi.numpy(), np.asarray(ji))
    assert np.array_equal(gq.numpy(), np.asarray(jq))


def test_nicam_product_unchanged(monkeypatch):
    """NICAM's taps stay below 2048: no split, one bmm per nicam_add, and
    the JAX package's numbers; DANCE's takes two."""
    t = TEncoder("i", RATE, device="cpu")
    st = t.nicam_statics
    assert st.pulse_hi is None and st.pulse_lo is None
    assert st.pulse.abs().max() < tsynth.EXACT_TAP
    calls = []
    real = torch.bmm
    monkeypatch.setattr(torch, "bmm",
                        lambda *a: calls.append(1) or real(*a))
    si, sq, offq, offr, cc = _dqpsk_inputs(st, 3)
    zero = torch.zeros((525, t.params.width))
    gi, gq = tsynth.nicam_add(st, zero, zero, si, sq, offq, offr, cc, 2)
    assert len(calls) == 1
    js = jsynth.make_nicam_statics(*(t.audio.nicam[k] for k in (
        "taps", "num", "den")), t.params.width, t.audio.nicam["timing"])
    ji, jq = jsynth.nicam_add(js, zero.numpy(), zero.numpy(), si.numpy(),
                              sq.numpy(), offq, offr, cc.numpy(), 2)
    assert np.array_equal(gi.numpy(), np.asarray(ji))
    assert np.array_equal(gq.numpy(), np.asarray(jq))
    td = _dance_encoder()
    sd = td.dance_statics
    si, sq, offq, offr, cc = _dqpsk_inputs(sd, 3)
    zd = torch.zeros((525, td.params.width))
    tsynth.nicam_add(sd, zd, zd, si, sq, offq, offr, cc, 0)
    assert len(calls) == 3


def test_split_pulse_refuses_taps_past_two_parts():
    with pytest.raises(ValueError):
        tsynth.split_pulse(np.array([[2048.0 * 64]], np.float32))
