"""The RF tail against hacktv_tpu, on the CPU: FM video's device closed
form, swap-IQ, the frequency offset, the passthru stream, raw baseband
and the two-channel mux; and glibc's large-argument sin/cos.

The module functions (`fm_video_modulate`, the offset statics and
rotation) equal the JAX package's on seeded inputs; whole encoders are
byte-identical to `hacktv_tpu.Encoder`, whose compiled step is the oracle
for every fused multiply-add, over sequential one-frame blocks 0-2:
PAL-FM with swap-IQ (with and without energy dispersal), PAL-I at 20 MS/s
4.5 MHz either side of centre (block 0 holds the offset's intro phasor),
both of those as one `MuxEncoder`, passthru and raw baseband from seeded
files, and SECAM with its field-identification lines (carrier phases
past 120 rad).  Inputs come from seeds."""

from __future__ import annotations

import ctypes
import ctypes.util
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu import mux as jmux
from hacktv_tpu.config import get_mode as jget_mode
from hacktv_tpu.rf import ops as jops
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import convert
from hacktv_tpu_torch.audio import synth as tsynth
from hacktv_tpu_torch.av.noise import NoiseSource
from hacktv_tpu_torch.config import get_mode as tget_mode
from hacktv_tpu_torch.mux import MuxEncoder as TMux
from hacktv_tpu_torch.rf import ops as tops

BLOCKS = 3
OFF = 2_250_000


# -- glibc's sinf/cosf past 120 rad -----------------------------------------
def test_sincosf_large_matches_libm():
    """_sincosf_glibc(large=True) against this machine's libm sinf/cosf
    (called through ctypes) on 200,000 seeded arguments with |x| spread
    log-uniformly over [120, 1e5], both signs, and the edges: 120 itself,
    the largest f32 below it, 2^24 and the f32 extremes."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for f in (libm.sinf, libm.cosf):
        f.restype = ctypes.c_float
        f.argtypes = [ctypes.c_float]
    rng = np.random.default_rng(120)
    n = 200_000
    mag = np.exp(rng.uniform(np.log(120.0), np.log(1e5), n))
    x = (mag * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    edges = np.float32([120.0, -120.0, np.nextafter(np.float32(120.0), 0),
                        2.0 ** 24, 3.4e38, -3.4e38, 0.5, -7.25])
    x = np.concatenate([x, edges])
    s, c = (t.numpy() for t in tsynth._sincosf_glibc(torch.from_numpy(x),
                                                     large=True))
    xl = x.tolist()
    ref_s = np.fromiter(map(libm.sinf, xl), np.float32, len(xl))
    ref_c = np.fromiter(map(libm.cosf, xl), np.float32, len(xl))
    assert s.tobytes() == ref_s.tobytes(), \
        f"sin: {np.count_nonzero(s != ref_s)} of {len(x)} differ"
    assert c.tobytes() == ref_c.tobytes(), \
        f"cos: {np.count_nonzero(c != ref_c)} of {len(x)} differ"


def test_sincosf_refuses_what_it_does_not_emulate():
    with pytest.raises(RuntimeError):
        tsynth._sincosf_glibc(torch.tensor([1.0, 130.0]))
    with pytest.raises(RuntimeError):
        tsynth._sincosf_glibc(torch.tensor([1.0, float("inf")]), large=True)


# -- module functions -------------------------------------------------------------
@pytest.mark.parametrize("rate,lines,ed", [(16_000_000, 625, 0.0625),
                                           (20_250_000, 525, 0.0)])
def test_fm_video_statics_equal(rate, lines, ed):
    tc.assert_same(tops.make_fm_video_statics(16e6, 1.0, rate, lines),
                   jops.make_fm_video_statics(16e6, 1.0, rate, lines))
    W = 1024
    tc.assert_same(tops.fm_energy_dispersal_frame(ed, W, lines),
                   jops.fm_energy_dispersal_frame(ed, W, lines))


@pytest.mark.parametrize("rate,with_tri", [(16_000_000, False),
                                           (16_000_000, True),
                                           (20_250_000, True)])
def test_fm_video_modulate_matches_jax(rate, with_tri):
    """Seeded composite (beyond int16, to exercise the clamp), energy
    dispersal triangle and phase carry: I, Q and the next carry equal
    JAX's, the phase reaching thousands of radians."""
    jst = jops.make_fm_video_statics(16e6, 1.0, rate, 625)
    tst = tops.make_fm_video_statics(16e6, 1.0, rate, 625)
    rng = np.random.default_rng(rate % 97 + with_tri)
    x = (rng.standard_normal((120, 1024)) * 12000).astype(np.float32)
    tri = (rng.integers(-2048, 2048, x.shape).astype(np.int32)
           if with_tri else None)
    r0 = int(rng.integers(0, jst.den))
    f = jax.jit(lambda x, r0, t: jops.fm_video_modulate(jst, x, r0, t))
    ji, jq, jr = f(x, jnp.int32(r0),
                   None if tri is None else jnp.asarray(tri))
    ti, tq, tr = tops.fm_video_modulate(
        tst, torch.from_numpy(x), torch.tensor(r0),
        None if tri is None else torch.from_numpy(tri))
    tc.assert_same(ti.numpy(), np.asarray(ji), "I")
    tc.assert_same(tq.numpy(), np.asarray(jq), "Q")
    assert int(tr) == int(jr)


@pytest.mark.parametrize("off,rate,W", [(-OFF, 20_000_000, 1280),
                                        (OFF, 20_000_000, 1280),
                                        (1_000_000, 16_000_000, 1024)])
def test_offset_statics_and_rotation_equal(off, rate, W):
    """The column table, the exact intro phasor and the per-line state of
    the first block, a block in the intro's last line and a later one."""
    j = jops.make_offset_statics(off, rate, W)
    t = tops.make_offset_statics(off, rate, W, device="cpu")
    for f in convert.OFFSET_FIELDS:
        tc.assert_same(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    for k0 in (0, 25, 3000):
        tc.assert_same(tops.offset_rotation(off, rate, k0, W, 40),
                       jops.offset_rotation(off, rate, k0, W, 40),
                       f"offset_rotation({k0})")


@pytest.mark.parametrize("off", [-OFF, OFF])
@pytest.mark.parametrize("k0", [0, 1000])
def test_offset_rotate_matches_jax(off, k0):
    """offset_rotate against JAX's jitted alone, at the intro (k0 = 0)
    and after it.  I is compared on a seeded block with fractional
    samples.  Of Q's two products the one XLA fuses depends on what is
    compiled with it (jitted alone it fuses out_i*bq, in the encoder's
    step out_q*bi, which the port follows and the encoder tests hold), so
    Q is compared where every product is exact in f32: samples that are
    integers below 2^9 in magnitude."""
    rate, W, B = 20_000_000, 1280, 40
    j = jops.make_offset_statics(off, rate, W)
    t = tops.make_offset_statics(off, rate, W, device="cpu")
    c0, s0, nz = jops.offset_rotation(off, rate, k0, W, B)
    k = np.maximum(np.arange(k0, k0 + B), 0).astype(np.int32)
    rng = np.random.default_rng(k0 + (off > 0))
    f = jax.jit(lambda *a: jops.offset_rotate(j, *a))
    th = torch.from_numpy
    rot = lambda oi, oq, *kr: tops.offset_rotate(
        t, th(oi), th(oq), th(c0), th(s0), th(nz), *kr)
    oi = (np.round(rng.standard_normal((B, W)) * 9000)
          + rng.random((B, W))).astype(np.float32)
    oq = np.round(rng.standard_normal((B, W)) * 9000).astype(np.float32)
    tc.assert_same(rot(oi, oq, th(k))[0].numpy(),
                   np.asarray(f(oi, oq, c0, s0, nz, k)[0]), "I")
    # without stream lines, the intro's samples are zeroed
    tc.assert_same(rot(oi, oq)[0].numpy(),
                   np.asarray(f(oi, oq, c0, s0, nz)[0]), "I, no intro")
    small = [np.clip(np.round(rng.standard_normal((B, W)) * 300), -511,
                     511).astype(np.float32) for _ in range(2)]
    for got, ref, what in zip(rot(*small, th(k)), f(*small, c0, s0, nz, k),
                              "IQ"):
        tc.assert_same(got.numpy(), np.asarray(ref), f"{what} (exact)")


# -- whole encoders ---------------------------------------------------------------
_JAX: dict = {}


def _files(tmp_dir):
    """Seeded passthru (I/Q pairs ending part-way through block 1's last
    line, so the short read drops it) and raw baseband files."""
    rng = np.random.default_rng(42)
    pt = tmp_dir / "passthru.bin"
    rng.integers(-32768, 32768, 2 * (640_000 + 1000) + 37).astype(
        np.int16).tofile(pt)
    rb = tmp_dir / "rawbb.bin"
    rng.integers(-200, 1000, 123_457).astype(np.int16).tofile(rb)
    return str(pt), str(rb)


def _configs(pt: str, rb: str) -> dict:
    """name: (JAX mode, port mode, sample rate, keyword arguments)."""
    ed = lambda g: replace(g("pal-fm"), fm_energy_dispersal=0.0625)
    fid = lambda g: replace(g("secam"), secam_field_id=True)
    return {
        "pal-fm-swap": ("pal-fm", "pal-fm", 16_000_000, {"swap_iq": True}),
        "pal-fm-ed-swap": (ed(jget_mode), ed(tget_mode), 16_000_000,
                           {"swap_iq": True}),
        "i-offset-minus": ("i", "i", 20_000_000, {"offset": -OFF}),
        "i-offset-plus": ("i", "i", 20_000_000, {"offset": OFF}),
        # FM video with passthru runs the device closed form
        "pal-fm-passthru": ("pal-fm", "pal-fm", 16_000_000,
                            {"passthru": pt}),
        "pal-passthru": ("pal", "pal", 16_000_000, {"passthru": pt}),
        "pal-rawbb": ("pal", "pal", 16_000_000, {
            "raw_bb_file": rb, "raw_bb_blanking": -10, "raw_bb_white": 900}),
        "secam-field-id": (fid(jget_mode), fid(tget_mode), 16_000_000, {}),
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("rf"))


def _jax_blocks(name, files):
    """The JAX encoder's blocks 0..BLOCKS-1, computed once per config."""
    if name not in _JAX:
        jmode, tmode, rate, kw = _configs(*files)[name]
        p = TEncoder(tmode, rate, device="cpu").params
        src = NoiseSource(p.active_width, p.conf.active_lines, seed=7)
        tc.jax_runtime()     # the FM-video modes' sound carrier needs it
        j = JEncoder(jmode, rate, source=src, **kw)
        _JAX[name] = (j, src, [j.encode_block(b) for b in range(BLOCKS)])
    return _JAX[name]


def _check(name, got, ref, block):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    snr, maxerr, ndiff = tc.error_report(got, ref)
    msg = (f"{name} block {block}: SNR {snr:.1f} dB, max error {maxerr}, "
           f"{ndiff} of {ref.size} values differ")
    assert ndiff == 0 and maxerr == 0 and snr == np.inf, msg


@pytest.mark.parametrize("name", ["pal-fm-swap", "pal-fm-ed-swap",
                                  "i-offset-minus", "i-offset-plus",
                                  "pal-fm-passthru", "pal-passthru",
                                  "pal-rawbb", "secam-field-id"])
def test_encoder_matches_jax(name, files):
    _, tmode, rate, kw = _configs(*files)[name]
    j, src, ref = _jax_blocks(name, files)
    if tmode == "pal-fm" or "swap_iq" in kw:
        assert j.fm_video_statics is not None   # the device closed form
    t = TEncoder(tmode, rate, source=src, device="cpu", **kw)
    for b in range(BLOCKS):
        _check(name, t.encode_block(b), ref[b], b)


def test_mux_matches_jax(files):
    """Two PAL-I transmitters 4.5 MHz apart on one 20 MS/s stream: the
    port's MuxEncoder against the JAX MuxEncoder's own wrap-add of the
    JAX channels' blocks (packed as its encoders hand them over)."""
    chans = [_jax_blocks(n, files) for n in ("i-offset-minus",
                                             "i-offset-plus")]
    t = TMux([TEncoder("i", 20_000_000, offset=o, source=c[1],
                       device="cpu") for o, c in zip((-OFF, OFF), chans)])
    for b in range(BLOCKS):
        packed = [jnp.asarray(np.ascontiguousarray(c[2][b]).view(np.int32)
                              .reshape(-1)) for c in chans]
        ref = np.asarray(jmux._sum_packed(packed)).view(np.int16).reshape(
            -1, 2)
        _check("mux", t.encode_block(b), ref, b)


def test_mux_refuses_host_fm_video():
    with pytest.raises(ValueError):
        TMux([TEncoder("pal-fm", 16_000_000, device="cpu")])


def test_fm_video_blocks_must_be_sequential():
    t = TEncoder("pal-fm", 16_000_000, swap_iq=True, device="cpu")
    t.encode_block_device(0)
    with pytest.raises(RuntimeError, match="sequentially"):
        t.encode_block_device(2)


def test_statics_carry_over():
    """PAL-FM with swap-IQ and energy dispersal, and PAL-I with an
    offset: the statics equal the JAX encoder's under convert.py's names,
    and a second port encoder with them installed gives the same
    blocks."""
    for name in ("pal-fm-ed-swap", "i-offset-minus"):
        _, tmode, rate, kw = _configs("", "")[name]
        j, src, ref = _jax_blocks(name, ("", ""))
        want = {"_fm_ed_frame": j._fm_ed_frame} \
            if j._fm_ed_frame is not None else {}
        if j.offset_statics is not None:
            want.update({"offset_statics." + f: np.asarray(
                getattr(j.offset_statics, f))
                for f in convert.OFFSET_FIELDS})
        t = TEncoder(tmode, rate, source=src, device="cpu", **kw)
        arrays = convert.statics_to_numpy(t)
        tc.assert_same({k: arrays[k] for k in want}, want, name)
        other = TEncoder(tmode, rate, source=src, device="cpu", **kw)
        convert.statics_from_numpy(other, arrays)
        tc.assert_same(convert.statics_to_numpy(other), arrays, "installed")
        for b in range(2):
            _check(f"{name} (carried statics)", other.encode_block(b),
                   ref[b], b)
