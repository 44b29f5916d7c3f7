"""The VBI symbol renderer (hacktv_tpu_torch/services/vbidata.py) against
hacktv_tpu's on the CPU: the raised-cosine and flat-top bases, the bit
unpacking on the host and on the device, and `render`, byte for byte on
numpy-seeded inputs.  `render` sums in f64 and rounds once to f32, which is
exact while every partial sum stays below 2^24: the bound is checked on
every service's basis at the rates the port runs them, and the result is
checked against the exact integer sum.  (TF32 exists only on the card; its
check is in tests/test_torch_cuda.py and chip_smoke.py.)"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from hacktv_tpu.services import vbidata as jvbi
from hacktv_tpu_torch.config import get_mode
from hacktv_tpu_torch.services import vbidata as tvbi
from hacktv_tpu_torch.services.acp import ACP
from hacktv_tpu_torch.services.cc608 import CC608
from hacktv_tpu_torch.services.sis import SiS
from hacktv_tpu_torch.services.teletext import Teletext
from hacktv_tpu_torch.services.vitc import VITC
from hacktv_tpu_torch.services.wss import WSS
from hacktv_tpu_torch.video.params import VideoParams

DEMO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "demo.tti")


def _params(mode, rate):
    return VideoParams.create(get_mode(mode), rate, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_basis_rc_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, width = int(rng.integers(8, 64)), int(rng.integers(200, 1200))
    args = (n, width, int(rng.integers(1000, 30000)),
            float(rng.uniform(1.5, 4.0)), float(rng.uniform(0.3, 1.0)),
            float(rng.uniform(0, 200)), int(rng.integers(0, 20)))
    tc.assert_same(tvbi.basis_rc(*args), jvbi.basis_rc(*args), "basis_rc")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_basis_step_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    n, width = int(rng.integers(8, 140)), int(rng.integers(200, 1200))
    args = (n, width, int(rng.integers(1000, 30000)),
            float(rng.uniform(2.0, 9.0)), float(rng.uniform(0.5, 4.0)),
            float(rng.uniform(0, 200)), int(rng.integers(0, 20)))
    tc.assert_same(tvbi.basis_step(*args), jvbi.basis_step(*args),
                   "basis_step")


@pytest.mark.parametrize("lsb_first", [True, False])
def test_bytes_to_bits_matches_jax(lsb_first):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 45).astype(np.uint8)
    for nbits in (1, 17, 137, 360):
        for d in (bytes(data), data):
            tc.assert_same(tvbi.bytes_to_bits(d, nbits, lsb_first),
                           jvbi.bytes_to_bits(d, nbits, lsb_first),
                           f"bytes_to_bits {nbits}")


@pytest.mark.parametrize("nbits", [32, 116, 360])
def test_device_unpack_bits_matches_jax(nbits):
    rng = np.random.default_rng(nbits)
    packed = rng.integers(0, 256, (37, (nbits + 7) // 8)).astype(np.uint8)
    got = tvbi.device_unpack_bits(torch.as_tensor(packed), nbits)
    ref = jvbi.device_unpack_bits(jnp.asarray(packed), nbits)
    tc.assert_same(got.numpy(), np.asarray(ref), "unpack")


def _bases():
    """Every service's basis at the rates the port runs it: name ->
    [n, W] f32."""
    out = {}
    for mode, rate in (("pal", 16_000_000), ("i", 20_250_000),
                       ("ntsc", 13_500_000), ("m", 13_513_500)):
        p = _params(mode, rate)
        tag = f"{mode}@{rate}"
        out[f"vitc {tag}"] = VITC(p, device="cpu").basis
        out[f"cc608 {tag}"] = CC608(p, device="cpu").basis
        if p.conf.lines == 625:
            out[f"wss {tag}"] = WSS(p, "16:9", device="cpu").basis
            out[f"teletext {tag}"] = Teletext(p, DEMO, device="cpu").basis
            if rate < 18_000_000:
                out[f"sis {tag}"] = SiS(p, "dcsis", None, 1, device="cpu").basis
    return out


BASES = _bases()


@pytest.mark.parametrize("name", sorted(BASES))
def test_render_matches_jax(name):
    """Seeded bits (a third set) through the basis: the port's render
    equals the JAX package's f32 HIGHEST matmul and the exact integer
    sum."""
    basis = BASES[name]
    rng = np.random.default_rng(len(name))
    bits = (rng.random((24, basis.shape[0])) < 0.33).astype(np.float32)
    got = tvbi.render(torch.as_tensor(bits), torch.as_tensor(basis))
    ref = np.asarray(jvbi.render(jnp.asarray(bits), basis))
    tc.assert_same(got.numpy(), ref, name)
    exact = bits.astype(np.int64) @ basis.astype(np.int64)
    assert np.array_equal(got.numpy().astype(np.int64), exact)


@pytest.mark.parametrize("name", sorted(BASES))
def test_render_exactness_bound(name):
    """Every partial sum of bits @ basis is an integer of magnitude at most
    the largest column sum of |basis|: below 2^24, where f32 is exact.
    Teletext's and WSS's pulses reach past 2^11, where TF32 would round."""
    basis = BASES[name]
    assert np.array_equal(basis, np.round(basis))
    assert tvbi.sum_bound(basis) < tvbi.EXACT_BOUND, name
    if name.startswith(("teletext", "wss")):
        assert np.abs(basis).max() > 2 ** 11


def test_acp_masks_integer():
    """ACP adds no basis: its levels and masks are exact small integers."""
    a = ACP(_params("pal", 16_000_000), device="cpu")
    assert set(np.unique(a.psync_mask)) <= {0.0, 1.0}
    assert abs(a.psync_level) < 2 ** 15
