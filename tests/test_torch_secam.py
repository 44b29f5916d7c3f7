"""SECAM colour against hacktv_tpu, on the CPU.

The host statics, the device program's constants and the per-line
metadata (with the IIR chain the JAX encoder builds) equal the JAX
package's; the chroma program equals the JAX one; `chroma_render` on
the CPU is that program and never reaches the card's kernel, whose host
constants are the program's; and whole SECAM
encoders are byte-identical to `hacktv_tpu.Encoder`, whose compiled step
is the oracle for every fused multiply-add, over sequential one-frame
blocks 0-2 (which cross the IIR carry twice).  SECAM-L with NICAM off,
its AM sound alone, is held in tests/test_torch_am_a2.py.  Inputs come
from seeds."""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu.config import get_mode as jget_mode
from hacktv_tpu.video import params as jparams
from hacktv_tpu.video import raster as jraster
from hacktv_tpu.video import secam as jsecam
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import telemetry
from hacktv_tpu_torch.audio import synth
from hacktv_tpu_torch.av.noise import NoiseSource
from hacktv_tpu_torch.config import get_mode as tget_mode
from hacktv_tpu_torch.ops import cuda_build
from hacktv_tpu_torch.video import params as tparams
from hacktv_tpu_torch.video import secam as tsecam

RATE = 16_000_000
W, NLINES = 1024, 625        # 625-line SECAM at 16 MS/s
CONFIGS = {
    "secam": ("secam", {}),
    "secam-fpb2": ("secam", {"frames_per_block": 2}),
    "l": ("l", {}),
    "l-vsb": ("l", {"vfilter": True}),
    "d": ("d", {}),
}
BLOCKS = 3
_JAX: dict = {}


def _params(mode, field_id):
    conf = lambda g: replace(g(mode), secam_field_id=field_id,
                             secam_field_id_lines=5 if field_id else 0)
    return (tparams.VideoParams.create(conf(tget_mode), RATE, 0),
            jparams.VideoParams.create(conf(jget_mode), RATE, 0))


@pytest.mark.parametrize("field_id", [False, True])
@pytest.mark.parametrize("mode", ["secam", "l", "d"])
def test_statics_and_line_meta_equal(mode, field_id):
    t, j = _params(mode, field_id)
    w, h = t.active_width, t.conf.active_lines
    ts, js = tsecam.make_statics(t, 0, w), jsecam.make_statics(j, 0, w)
    tc.assert_same(ts, js, f"SecamStatics({mode})")
    jc = jsecam._device_consts(js, W)
    tc.assert_same(tsecam.device_consts(ts, W),
                   {k: v for k, v in jc.items() if k != "W"}, "consts")
    for k0 in (-1, NLINES - 1, 7 * NLINES + 3):
        tc.assert_same(tsecam.line_meta(t, k0, NLINES + 2, 0, h),
                       jsecam.line_meta(j, k0, NLINES + 2, 0, h),
                       f"line_meta({mode}, {k0})")


@pytest.mark.parametrize("block", [0, 1, 4])
def test_block_meta_equal_encoder(block):
    """block_meta (line_meta + the IIR chain) against the metadata the
    JAX encoder hands its step."""
    j = JEncoder("secam", RATE)
    t = TEncoder("secam", RATE, device="cpu")
    j._secam_z[block] = jnp.float32(0.0)    # a carry, as if in sequence
    jm = j._audio_args(block)["secam"]
    k0 = block * NLINES
    tm = tsecam.block_meta(t.params, k0 - 1, NLINES + 2, NLINES,
                           t.vframe_y, t.source.height)
    tc.assert_same(tm, {k: np.asarray(v) for k, v in jm.items()},
                   f"block_meta({block})")


@pytest.mark.parametrize("block", [0, 1])
def test_chroma_program_equal(block):
    """device_chroma_carrier on the test card's SECAM planes against the
    JAX function jitted on its own, with a carried z: the carrier add-in
    and the next block's z."""
    t = TEncoder("secam", RATE, device="cpu")
    p = t.params
    j = jparams.VideoParams.create(jget_mode("secam"), RATE, 0)
    rgb = t.source.read_video(0)
    _, u, v = jraster.rgb_to_yuv_host(j, rgb, True)
    js = jsecam.make_statics(j, 0, p.active_width)
    nm = tsecam.block_meta(p, block * NLINES - 1, NLINES + 2, NLINES, 0,
                           t.source.height)
    z0 = np.float32(-1234.5)
    jo, jz = jax.jit(lambda m, u, v, z: jsecam.device_chroma_carrier(
        js, W, m, u, v, z))({k: jnp.asarray(a) for k, a in nm.items()},
                            jnp.asarray(u), jnp.asarray(v), jnp.float32(z0))
    to, tz = tsecam.device_chroma_carrier(
        t.secam, tsecam.meta_to_device(nm, "cpu"), torch.as_tensor(u),
        torch.as_tensor(v), torch.tensor(z0))
    jo = np.asarray(jo)
    assert to.numpy().tobytes() == jo.tobytes(), \
        f"{np.count_nonzero(to.numpy() != jo)} of {jo.size} samples differ"
    assert np.float32(tz) == np.float32(jz)


@pytest.mark.parametrize("luma", [True, False])
def test_chroma_render_on_the_cpu_is_the_plain_program(monkeypatch, luma):
    """chroma_render on CPU tensors is the plain program byte for byte
    (device_chroma_carrier, then render, or the bare sum for S-Video's C
    channel), and never builds or counts the card's kernel."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the CUDA build")
    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build_all", refuse)
    t = TEncoder("l", RATE, device="cpu")
    p = t.params
    nm = tsecam.block_meta(p, NLINES - 1, NLINES + 2, NLINES, t.vframe_y,
                           t.source.height)
    md = tsecam.meta_to_device(nm, "cpu")
    _, u, v = jraster.rgb_to_yuv_host(
        jparams.VideoParams.create(jget_mode("l"), RATE, 0),
        t.source.read_video(0), True)
    u, v = torch.as_tensor(u), torch.as_tensor(v)
    rng = np.random.default_rng(29)
    blk = torch.as_tensor(np.round(rng.standard_normal((NLINES + 2, W))
                                   * 9000).astype(np.float32))
    z0 = torch.tensor(-1234.5)
    k0 = telemetry.counters().get("secam.kernel_windows", 0)
    out, z = tsecam.chroma_render(t.secam, md, u, v, z0, blk, luma=luma)
    assert telemetry.counters().get("secam.kernel_windows", 0) == k0
    add, zw = tsecam.device_chroma_carrier(t.secam, md, u, v, z0)
    want = tsecam.render(t.secam, blk, add, md) if luma else blk + add
    assert out.numpy().tobytes() == want.numpy().tobytes()
    assert z.numpy().tobytes() == zw.numpy().tobytes()


@pytest.mark.parametrize("mode,rate", [("l", RATE), ("secam", 20_250_000),
                                       ("d", 13_500_000)])
def test_kernel_consts_are_the_plain_programs(mode, rate):
    """The card kernel's host constants (kernel_consts, in the order of
    csrc/secam_chroma.cu's enums) hold what the plain program computes
    with: the row geometry, the doubling scan's shifts and f32 factors,
    the integer taps in accumulation order (the luma's as render's conv1d
    weights), the f32 constants and glibc's tables."""
    t = TEncoder(mode, rate, device="cpu")
    sd, st = t.secam, t.secam.st
    fc, ic = sd.kconst
    assert fc.shape == (tsecam._N_FC,) and ic.shape == (tsecam._N_IC,)
    Wd = st.width
    steps = tsecam._scan_steps(Wd)
    assert 0 < len(steps) <= tsecam._N_STEPS
    assert list(ic[:11]) == [
        Wd, 0, 0, st.col0, st.active_left,
        st.active_left + st.active_width, st.half_width, st.burst_left,
        min(st.burst_left + st.burst_len, Wd), len(steps), 1]
    assert list(ic[10:10 + len(steps)]) == [sh for sh, _ in steps]
    assert list(fc[28:28 + len(steps)]) == [rr for _, rr in steps]
    assert list(ic[26:41]) == list(sd.chroma_tq[::-1])
    assert np.array_equal(ic[41:92], sd.luma_w.reshape(-1).numpy())
    assert list(ic[92:]) == list(synth._INV_PIO4)
    assert list(fc[:6]) == [st.u_black, st.v_black, st.dmin[0],
                            st.dmin[1], st.dmax[0], st.dmax[1]]
    assert all(float(np.float32(x)) == x for x in fc[:16])
    assert list(fc[16:28]) == [synth._SC_HPI_INV, synth._SC_HPI_HI,
                               synth._SC_HPI_LO, synth._SC_PI63,
                               *synth._SC_C, *synth._SC_S]


# -- whole encoders ------------------------------------------------------------
def _source(mode):
    p = TEncoder(mode, RATE, device="cpu").params
    return NoiseSource(p.active_width, p.conf.active_lines, seed=7)


def _jax_blocks(name):
    """The JAX encoder's blocks 0..BLOCKS-1, computed once per config."""
    if name not in _JAX:
        mode, kw = CONFIGS[name]
        src = _source(mode)
        j = JEncoder(mode, RATE, source=src, **kw)
        nb = 2 if kw.get("frames_per_block", 1) > 1 else BLOCKS
        _JAX[name] = (j, src, [j.encode_block(b) for b in range(nb)])
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
    for b in range(len(ref)):
        _check(name, t.encode_block(b), ref[b], b)


def test_secam_blocks_must_be_sequential():
    t = TEncoder("secam", RATE, device="cpu")
    t.encode_block(0)
    with pytest.raises(RuntimeError, match="sequentially"):
        t.encode_block(2)
    with pytest.raises(RuntimeError, match="sequentially"):
        TEncoder("secam", RATE, device="cpu").encode_block(3)


@pytest.mark.parametrize("kw,exc", [
    ({"pixel_rate": 13_500_000}, NotImplementedError),
    ({"devices": ["cpu"] * 3}, ValueError),
    ({"moving": True, "pixel_rate": 13_500_000}, NotImplementedError)],
    ids=["kw0", "kw1", "kw2"])
def test_unported_secam_options_raise(kw, exc):
    """SECAM with the video resampler (--pixelrate, which the JAX package
    cannot run either), also from a moving-video source (which SECAM
    takes without it, tests/test_torch_moving.py), raises; none falls
    back to another path.  Sharded over devices (tests/test_torch_
    devices_*.py), a block that does not divide over them is refused."""
    kw = dict(kw)
    conf = tget_mode("l")
    if kw.pop("moving", False):
        # a source without `stateless` reads new frames as it goes
        kw["source"] = type("Moving", (), {"width": 10, "height": 10})()
    with pytest.raises(exc):
        TEncoder(conf, RATE, device="cpu", **kw)
