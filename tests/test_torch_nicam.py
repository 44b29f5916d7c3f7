"""NICAM-728 and the PAL-I chain against hacktv_tpu, on the CPU.

The bit domain (J.17, the frame coder, the differential sign stream) is
held byte-equal to both of the JAX package's coders, the device one
(`nicam_dev.signs_device`, jitted) and the host one
(`nicam.encode_frames`); the pulse synthesis and its int32 carrier mix
byte-equal to `synth.nicam_add`; the FM rotation chain and whole
encoders byte-equal to `hacktv_tpu.Encoder`, whose compiled step is the
oracle for every fused multiply-add.  Inputs come from seeds."""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu.audio import nicam as jnicam
from hacktv_tpu.audio import nicam_dev as jnd
from hacktv_tpu.audio import synth as jsynth
from hacktv_tpu.config import get_mode as jget_mode
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import convert
from hacktv_tpu_torch.audio import nicam as tnicam
from hacktv_tpu_torch.audio import nicam_dev as tnd
from hacktv_tpu_torch.audio import synth as tsynth
from hacktv_tpu_torch.av.noise import NoiseSource
from hacktv_tpu_torch.config import get_mode as tget_mode

RATE = 16_000_000
W, NLINES = 1024, 625        # PAL at 16 MS/s
CONFIGS = {
    "i": ("i", {}),
    "i-vsb": ("i", {"vfilter": True}),
    "i-direct": ("i", {"fm_direct_trig": True}),
    "g": ("g", {}),
}
SEEK = 3                     # a stream that starts at this block
_JAX: dict = {}


def _pcm(n, seed):
    """Seeded full-scale stereo PCM, history rows included."""
    return np.random.default_rng(seed).integers(
        -32768, 32768, (n, 2)).astype(np.int16)


@pytest.fixture(scope="module")
def enc_i():
    """The port's one-frame PAL-I encoder on the CPU, for its statics."""
    return TEncoder("i", RATE, device="cpu")


# -- the bit domain --------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_j17_equal(enc_i, seed):
    x = _pcm(20_000, seed)
    x[:300] = (32767, -32768)                # the accumulator's extremes
    x[300:600] = (-32768, 32767)
    got = tnd._j17(enc_i.nicam_dev_statics, torch.as_tensor(x.T)).numpy()
    jst = jnd.make_dev_statics(52, 26208, 2912)
    for ch in range(2):
        ref = np.asarray(jnd._j17(jst, jnp.asarray(x[:, ch], jnp.int32)))
        assert got.dtype == ref.dtype and np.array_equal(got[ch], ref)
        host = jnicam.j17_filter(x[:, ch])
        assert np.array_equal(got[ch], host)
        assert np.array_equal(tnicam.j17_filter(x[:, ch]), host)


@pytest.fixture(scope="module")
def jax_signs():
    """hacktv_tpu's device encoder at the one-frame block's shapes,
    jitted on the CPU as the JAX encoder runs it."""
    dst = jnd.make_dev_statics(52, 26208, 2912)
    return dst, jax.jit(functools.partial(jnd.signs_device, dst))


@pytest.mark.parametrize("famod16", [0, 9])
@pytest.mark.parametrize("seed", [2, 3])
def test_signs_device_equal(enc_i, jax_signs, seed, famod16):
    dst, jfn = jax_signs
    tst = enc_i.nicam_dev_statics
    assert (tst.nf_max, tst.L, tst.spp) == (dst.nf_max, dst.L, dst.spp)
    pcm = _pcm(tst.nf_max * 32 + 82, seed)
    base_off, nkeep = 1000 + 7 * seed, (40 + seed) * 364
    ji, jq, jd = jfn(jnp.asarray(pcm), jnp.int32(seed), jnp.int32(famod16),
                     jnp.int32(base_off), jnp.int32(nkeep))
    ti, tq, td = tnd.signs_device(tst, torch.as_tensor(pcm),
                                  torch.tensor(seed, dtype=torch.int32),
                                  famod16, base_off, nkeep)
    for name, a, b in (("signs_i", ti, ji), ("signs_q", tq, jq),
                       ("dsym_out", td, jd)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("native", [True, False])
def test_signs_equal_host_coder(enc_i, native, monkeypatch):
    """The device encoder against the host coder, frames 0-51 of a
    stream: frame 0 is the modulator's initial silence, frame f carries
    pairs [32(f-1), 32f).  The JAX coder's native and numpy paths both
    serve as oracle, and the port's own numpy copy must agree."""
    monkeypatch.setattr(jnicam, "_NO_NATIVE", not native)
    tst = enc_i.nicam_dev_statics
    audio = _pcm(tst.nf_max * 32, 4)
    pcm = np.concatenate([np.zeros((32 + 82, 2), np.int16),
                          audio[:(tst.nf_max - 1) * 32]])
    n = tst.nf_max * 364
    ti, tq, td = tnd.signs_device(tst, torch.as_tensor(pcm),
                                  torch.tensor(0, dtype=torch.int32), 0, 0,
                                  n)
    for coder in (jnicam, tnicam):
        frames = coder.encode_frames(pcm.astype(np.int64), 0)
        pairs = coder.frame_symbols(frames).reshape(-1)
        signs, dsym = coder.differential_encode(pairs, 0)
        assert np.array_equal(ti.numpy()[:n], signs[:, 0])
        assert np.array_equal(tq.numpy()[:n], signs[:, 1])
        assert int(td) == dsym


# -- the pulse synthesis ---------------------------------------------------
@pytest.mark.parametrize("mode", ["i", "g"])
def test_make_nicam_statics_equal(mode):
    t = TEncoder(mode, RATE, device="cpu")
    nt = t.audio.nicam
    j = jsynth.make_nicam_statics(nt["taps"], nt["num"], nt["den"], W,
                                  nt["timing"])
    st = t.nicam_statics
    for name in ("pulse", "lut_i", "lut_q"):
        tc.assert_same(getattr(st, name).numpy(), np.asarray(getattr(j, name)),
                       name)
    tc.assert_same(st.kf, j.kf, "kf")
    assert (st.den, st.period, st.nslot, st.syms_per_period) == \
        (j.den, j.period, j.nslot, j.syms_per_period)


@pytest.mark.parametrize("k0", [1, 7 * NLINES + 1])
def test_nicam_add_equal(k0):
    """Random signs (zeros in the pre-stream period), the window offsets
    and carrier offsets of a real block, and a video block to add to."""
    t = TEncoder("i", RATE, device="cpu")
    st, dst, chain = t.nicam_statics, t.nicam_dev_statics, t.audio
    nc = chain.nicam_device_block(k0, NLINES, st, dst, t._nicam_dev_fn)
    rng = np.random.default_rng(k0)
    signs = rng.choice(np.float32([-1, 1]), (2, dst.L))
    signs[:, :dst.spp // 2] = 0
    y = np.round(rng.standard_normal((2, NLINES, W)) * 8000).astype(
        np.float32)
    jst = jsynth.make_nicam_statics(chain.nicam["taps"], chain.nicam["num"],
                                    chain.nicam["den"], W,
                                    chain.nicam["timing"])
    k0_mod = k0 % st.period
    ji, jq = jax.jit(lambda *a: jsynth.nicam_add(jst, *a, k0_mod))(
        *map(jnp.asarray, (y[0], y[1], signs[0], signs[1], nc["offq"],
                           nc["offr"], nc["cc_off"])))
    ti, tq = tsynth.nicam_add(st, torch.from_numpy(y[0]),
                              torch.from_numpy(y[1]),
                              torch.from_numpy(signs[0]),
                              torch.from_numpy(signs[1]), nc["offq"],
                              nc["offr"], torch.as_tensor(nc["cc_off"]),
                              k0_mod)
    for name, a, b in (("I", ti, ji), ("Q", tq, jq)):
        a, b = a.numpy(), np.asarray(b)
        assert a.tobytes() == b.tobytes(), \
            f"nicam_add {name}: {np.count_nonzero(a != b)} samples differ"


# -- the FM rotation chain ---------------------------------------------------
@pytest.mark.parametrize("k0", [1, 7 * NLINES + 1])
def test_fm_chain_equal(k0):
    """fm_add's K=4 rotation chain (W = 1024) against the JAX encoder's
    compiled step, with NICAM off so that only the FM carrier rides on
    the filtered video: one-frame blocks whose audio timeline starts at
    line k0 (the filter's one-line lag), from a fresh encoder each."""
    block = (k0 - 1) // NLINES
    src = NoiseSource(832, 576, seed=5)
    j = JEncoder(replace(jget_mode("i"), nicam_level=0.0), RATE,
                 vfilter=True, source=src)
    t = TEncoder(replace(tget_mode("i"), nicam_level=0.0), RATE,
                 vfilter=True, source=src, device="cpu")
    assert not t.fm_statics.direct and t.params.width % 128 == 0
    _check(f"FM chain k0={k0}", t.encode_block(block), j.encode_block(block),
           block)


# -- whole encoders ------------------------------------------------------------
def _source(mode):
    p = TEncoder(mode, RATE, device="cpu").params
    return NoiseSource(p.active_width, p.conf.active_lines, seed=7)


def _jax_blocks(name):
    """The JAX encoder's blocks 0..SEEK, computed once per config."""
    if name not in _JAX:
        mode, kw = CONFIGS[name]
        src = _source(mode)
        j = JEncoder(mode, RATE, source=src, **kw)
        _JAX[name] = (j, src, [j.encode_block(b) for b in range(SEEK + 1)])
    return _JAX[name]


def _check(name, got, ref, block):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    snr, maxerr, ndiff = tc.error_report(got, ref)
    msg = (f"{name} block {block}: SNR {snr:.1f} dB, max error {maxerr}, "
           f"{ndiff} of {ref.size} values differ")
    assert ndiff == 0 and maxerr == 0 and snr == np.inf, msg


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_matches_jax(name):
    mode, kw = CONFIGS[name]
    _, src, ref = _jax_blocks(name)
    t = TEncoder(mode, RATE, source=src, device="cpu", **kw)
    for b in range(2):
        _check(name, t.encode_block(b), ref[b], b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_seek_matches_jax(name):
    """A stream that starts at block SEEK: the FM anchor is seeded on the
    host and the NICAM differential state caught up on the device."""
    mode, kw = CONFIGS[name]
    _, src, ref = _jax_blocks(name)
    t = TEncoder(mode, RATE, source=src, device="cpu", **kw)
    _check(name, t.encode_block(SEEK), ref[SEEK], SEEK)


def test_nicam_blocks_must_be_sequential():
    t = TEncoder(replace(tget_mode("i"), fm_mono_level=0.0), RATE,
                 device="cpu")
    t._audio_args(0)                 # a block whose step never ran
    with pytest.raises(RuntimeError):
        t._audio_args(1)


def test_statics_carry_over_i():
    j, src, ref = _jax_blocks("i")
    t = TEncoder("i", RATE, source=src, device="cpu")
    st = j.statics
    arrays = {f: np.asarray(getattr(st, f)) for f in convert.RASTER_FIELDS
              if getattr(st, f) is not None and f != "carrier_rows"}
    if st.carrier_rows is not None:
        arrays["carrier_rows"] = np.stack([np.asarray(a)
                                           for a in st.carrier_rows])
    arrays["cos_x"] = np.asarray(j.fm_statics.cos_x)
    arrays["sin_x"] = np.asarray(j.fm_statics.sin_x)
    arrays["lens_tiled"] = np.asarray(j.fm_win.lens_tiled)
    for f in convert.NICAM_FIELDS:
        arrays[f] = np.asarray(getattr(j.nicam_statics, f))
    for f in convert.NICAM_DEV_FIELDS:
        arrays[f] = np.asarray(getattr(j.nicam_dev_statics, f))
    tc.assert_same(convert.statics_to_numpy(t), arrays, "statics")
    other = TEncoder("i", RATE, source=src, device="cpu")
    convert.statics_from_numpy(other, arrays)
    tc.assert_same(convert.statics_to_numpy(other), arrays, "installed")
    for b in range(2):
        _check("i (carried statics)", other.encode_block(b), ref[b], b)
