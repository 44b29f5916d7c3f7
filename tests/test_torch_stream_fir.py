"""The stream FIR (ops/stream_fir.py) against hacktv_tpu's Pallas kernels
(ops/pallas_fir.py, run in interpret mode on the CPU).  The CUDA kernels
are held against the plain version in tests/test_torch_cuda.py.

Tolerance: exactly equal on I and on the real output.  The JAX reference's
CPU backend fuses one product of each multiply-add in tap order, and the
port's fused chain with the same first step (fuse_second) reproduces it.
Q is held to f32 max|a-b| <= 1e-6 max|b| and, after rounding, at most
1 LSB on at most 1e-3 of the samples; it has measured exact too."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread cap)
from hacktv_tpu.ops import pallas_fir
from hacktv_tpu_torch.ops import stream_fir as sf

# (seed, taps, outputs): n is deliberately not a multiple of 2048
CASES = [(0, 51, 49229), (1, 51, 30001), (2, 7, 5003), (3, 7, 20011)]


def _inputs(seed, nt, n, signs=None):
    rng = np.random.default_rng(seed)
    xs = (rng.standard_normal(n + nt - 1) * 20000).astype(np.float32)
    tr = rng.standard_normal(nt).astype(np.float32)
    ti = rng.standard_normal(nt).astype(np.float32)
    if signs is not None:
        # pin the signs of r[0] = taps[-1] and r[1] = taps[-2]
        tr[-1] = abs(tr[-1]) * signs[0]
        tr[-2] = abs(tr[-2]) * signs[1]
    return xs, tr, ti


@pytest.mark.parametrize("seed,nt,n", CASES)
def test_complex_matches_pallas(seed, nt, n):
    xs, tr, ti = _inputs(seed, nt, n)
    ji, jq = map(np.asarray, pallas_fir.stream_fir(jnp.asarray(xs), tr, ti,
                                                   n))
    ti_, tq = sf.stream_fir(torch.from_numpy(xs), torch.from_numpy(tr),
                            torch.from_numpy(ti), n)
    ti_, tq = ti_.numpy(), tq.numpy()
    assert ti_.shape == ji.shape == (n,)
    assert np.array_equal(ti_, ji), \
        f"I: {np.count_nonzero(ti_ != ji)} of {n} differ"
    err = float(np.abs(tq - jq).max())
    assert err <= 1e-6 * float(np.abs(jq).max()), \
        f"Q: max|a-b| {err}, {np.count_nonzero(tq != jq)} of {n} differ"
    lsb = np.abs(np.round(tq).astype(np.int64) - np.round(jq).astype(np.int64))
    assert lsb.max() <= 1 and np.count_nonzero(lsb) <= 1e-3 * n, \
        f"Q after round: {np.count_nonzero(lsb)} flips"


@pytest.mark.parametrize("signs", [(1, 1), (-1, 1), (1, -1), (-1, -1)])
@pytest.mark.parametrize("seed,nt,n", CASES[1:3])
def test_real_matches_pallas(seed, nt, n, signs):
    """Every sign pattern of the first two reversed taps, which decide
    the first fused step."""
    xs, tr, _ = _inputs(seed, nt, n, signs)
    jr = np.asarray(pallas_fir.stream_fir(jnp.asarray(xs), tr, None, n))
    tr_ = sf.stream_fir(torch.from_numpy(xs), torch.from_numpy(tr), None,
                        n).numpy()
    assert np.array_equal(tr_, jr), \
        f"{np.count_nonzero(tr_ != jr)} of {n} differ"


def test_fuse_second_rule():
    assert sf.fuse_second(-0.5, 0.25)
    for r0, r1 in ((0.5, 0.25), (0.5, -0.25), (-0.5, -0.25), (-0.0, 0.5),
                   (0.5, 0.0)):
        assert not sf.fuse_second(r0, r1)


def test_wrapper_checks():
    xs = torch.zeros(100)
    taps = torch.ones(51)
    with pytest.raises(ValueError):
        sf.fir_real(xs, taps, 60)                   # too few samples
    with pytest.raises(ValueError):
        sf.fir_real(xs.double(), taps.double(), 10)  # wrong dtype
    with pytest.raises(ValueError):
        sf.fir_cplx(xs, taps, torch.ones(7), 10)     # tap counts differ
    with pytest.raises(ValueError):
        sf.fir_real(torch.zeros(400), torch.ones(sf.MAX_TAPS + 1), 10)
