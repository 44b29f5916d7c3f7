"""D/D2-MAC encoders (video/mac.py MacEncoder, on the CPU) against
hacktv_tpu, byte for byte: Eurocrypt EC-M (filmnet) on D2-MAC FM with
scrambled audio and 3DES (cplus) on D-MAC FM, MAC teletext from a TTI
page and from raw packets, mono medium-quality linear audio with
second-level protection, the pixel-rate resampler over blocks 0-3, a
seeded moving source in two-frame blocks, the pipelined multiplex; the
exact f64 duobinary products against the plain f32 ones, the MAC statics
carried over from the JAX encoder (convert.py), create_encoder, and the
refusals."""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import _torch_common as tc
from _torch_mac import (NOW, RATE, JEurocrypt, JMacEncoder, TEurocrypt,
                        check_blocks, encoders)
from hacktv_tpu import create_encoder as jcreate
from hacktv_tpu.config.standards import get_mode as jget_mode
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import convert, create_encoder, runtime
from hacktv_tpu_torch.av.noise import MovingNoiseSource
from hacktv_tpu_torch.config.standards import get_mode as tget_mode
from hacktv_tpu_torch.video import mac as tmac

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode,provider,kw", [
    ("d2mac-fm", "filmnet", {"scramble_audio": True}),
    ("dmac-fm", "cplus", {"scramble_video": 2}),
], ids=["d2mac-fm-filmnet", "dmac-fm-cplus"])
def test_eurocrypt_encoder_matches_jax(mode, provider, kw):
    j, t = encoders(mode, kw,
                    jkw={"eurocrypt": JEurocrypt(provider, now=NOW)},
                    eurocrypt=TEurocrypt(provider, now=NOW))
    assert t.vsam == j.vsam and t.vsam & 4
    check_blocks(f"{mode} {provider}", j, t, range(3))


@pytest.mark.parametrize("path", ["tests/data/demo.tti",
                                  "raw:tests/data/raw_tt_packets.bin"],
                         ids=["tti", "raw"])
def test_mac_teletext_matches_jax(path, monkeypatch):
    """MAC teletext packets in the line bits (the host-bits step), the
    teletext clock pinned."""
    monkeypatch.chdir(REPO)
    clock = lambda: NOW
    j, t = encoders("d2mac", {"teletext": path, "teletext_clock": clock})
    assert not t.device_mat and not j.device_mat
    check_blocks(f"d2mac teletext {path}", j, t, range(3))


def test_mono_medium_linear_l2_audio_matches_jax():
    over = dict(mac_audio_stereo=False, mac_audio_quality=False,
                mac_audio_companded=False, mac_audio_protection=True)
    tc.jax_runtime()
    j = JMacEncoder(replace(jget_mode("d2mac"), **over), RATE)
    t = tmac.MacEncoder(replace(tget_mode("d2mac"), **over), RATE,
                        device="cpu")
    assert t.mux.audio.address == j.mux.audio.address
    check_blocks("d2mac mono medium linear L2", j, t, range(3))


def test_pixel_rate_matches_jax():
    """The raster at 13.5 MHz resampled to 20.25 MS/s: the halo rows,
    block 0's zeroed leading row, the audio three lines behind."""
    j, t = encoders("d2mac", {"pixel_rate": 13_500_000})
    assert t.mux.audio_lag == j.mux.audio_lag == 3
    check_blocks("d2mac pixel rate", j, t, range(4))


def test_moving_source_two_frame_blocks_match_jax():
    src = MovingNoiseSource(702, 576)
    j, t = encoders("d2mac", {"source": src, "frames_per_block": 2})
    check_blocks("d2mac moving, 2 frames", j, t, range(3))


def test_pipelined_multiplex_matches_jax():
    """pipeline_mux: the next block's multiplex on a worker thread gives
    the same bytes."""
    j, t = encoders("dmac-fm", {"scramble_video": 1}, pipeline_mux=True)
    check_blocks("dmac-fm pipelined", j, t, range(3))


@pytest.mark.parametrize("mode", ["d2mac-am", "d2mac", "dmac-fm"])
def test_duobinary_products_are_exact(mode):
    """The bases reach |13,107|, past TF32's 11 bits: the products run in
    f64 and equal the plain f32 products (exact on the CPU) and the JAX
    package's f32 matmul at HIGHEST precision, on seeded symbols."""
    import jax.numpy as jnp
    from jax.lax import Precision
    t = tmac.MacEncoder(mode, RATE, device="cpu")
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (42, t.mux.nbits))
    sym = bits * rng.choice([-1, 1], (42, 1))
    assert max(np.abs(B).max() for B in (t.Bm, t.B0, t.Bp)) >= 2048
    got = tmac.duobinary_products(t.d_bases, torch.as_tensor(
        sym, dtype=torch.float64))
    s32 = torch.as_tensor(sym, dtype=torch.float32)
    f32 = [torch.as_tensor(B) for B in (t.Bm, t.B0, t.Bp)]
    plain = (s32[1:41] @ f32[1] + s32[0:40] @ f32[2], s32[2:42] @ f32[0])
    js = jnp.asarray(sym, jnp.float32)
    mm = lambda a, B: jnp.matmul(a, jnp.asarray(B),
                                 precision=Precision.HIGHEST)
    ref = (mm(js[1:41], t.B0) + mm(js[0:40], t.Bp), mm(js[2:42], t.Bm))
    for g, p, r in zip(got, plain, ref):
        assert g.dtype == torch.float32
        assert torch.equal(g, p)
        tc.assert_same(g.numpy(), np.asarray(r), "products")


def test_mac_statics_carry_over():
    """The bases and base bit rows, read from the JAX encoder under
    convert.py's names, equal the port's; installed on a second port
    encoder they give the JAX encoder's bytes."""
    j, t = encoders("dmac-fm")
    arrays = convert.statics_to_numpy(t)
    want = {"mac.Bm": j.Bm, "mac.B0": j.B0, "mac.Bp": j.Bp,
            "mac.base_bits": j._base_bits}
    tc.assert_same(arrays, want, "MAC statics")
    _, other = encoders("dmac-fm")
    convert.statics_from_numpy(other, {k: np.asarray(v)
                                       for k, v in want.items()})
    tc.assert_same(convert.statics_to_numpy(other), arrays, "installed")
    check_blocks("dmac-fm (carried)", j, other, range(2))


@pytest.mark.parametrize("mode,kw", [
    ("d2mac-am", {"scramble_video": 1, "frames_per_block": 1}),
    ("pal", {"frames_per_block": 1}),
])
def test_create_encoder_matches_jax(mode, kw):
    """create_encoder picks MacEncoder for a MAC mode and Encoder for the
    others, as hacktv_tpu's does, with the same bytes."""
    tc.jax_runtime()
    j = jcreate(mode, RATE, **kw)
    t = create_encoder(mode, RATE, device="cpu", **kw)
    assert type(t).__name__ == type(j).__name__
    if mode == "pal":
        assert isinstance(t, TEncoder)
    check_blocks(f"create_encoder {mode}", j, t, range(2))


def test_refusals():
    """Out-of-order blocks, a raster mode, a checkpoint at another block
    than the stream's next (tests/test_torch_checkpoint_b.py has the rest)
    and more than one device are refused; Encoder refuses a MAC mode
    (hacktv_tpu's Encoder fails on it too)."""
    t = tmac.MacEncoder("d2mac", RATE, device="cpu")
    t.encode_block_device(0)
    with pytest.raises(RuntimeError, match="sequentially"):
        t.encode_block_device(2)
    with pytest.raises(RuntimeError, match="stream is at 1"):
        t.checkpoint(2)
    with pytest.raises(ValueError, match="D/D2-MAC"):
        tmac.MacEncoder("pal", RATE, device="cpu")
    with pytest.raises(ValueError, match="MacEncoder"):
        TEncoder("dmac-fm", RATE, device="cpu")
    from hacktv_tpu import Encoder as JEncoder
    with pytest.raises(KeyError):            # its raster table has no MAC
        JEncoder("dmac-fm", RATE)


def test_main_path_raises_without_native_runtime(monkeypatch):
    """The multiplex's native calls do not fall back: without the runtime
    the encoder raises."""
    def fail():
        raise RuntimeError("no native runtime")
    monkeypatch.setattr(runtime, "load", fail)
    t = tmac.MacEncoder("d2mac", RATE, device="cpu")
    with pytest.raises(RuntimeError, match="no native runtime"):
        t.encode_block(0)
