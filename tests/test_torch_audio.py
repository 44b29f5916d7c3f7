"""The FM sound path (audio/limiter.py, audio/synth.py, audio/chain.py)
against hacktv_tpu, on seeded full-scale noise.  Every layer is exactly
equal: the integer layers by construction, fm_add because it computes
cos/sin as glibc does (the JAX CPU backend calls glibc's sincosf) and
fuses the multiply-adds that XLA's CPU compiler fuses when fm_prepare
and fm_add run in one compiled step, as in the JAX encoder."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread cap)
from hacktv_tpu.audio import chain as jchain
from hacktv_tpu.audio import synth as jsynth
from hacktv_tpu.config import get_mode as jget_mode
from hacktv_tpu_torch.audio import chain as tchain
from hacktv_tpu_torch.audio import synth as tsynth
from hacktv_tpu_torch.av.noise import NoiseSource
from hacktv_tpu_torch.config import get_mode as tget_mode

RATE = 13_500_000
W = 858           # NTSC-M samples per line at 13.5 MS/s
NLINES = 525


@pytest.fixture(scope="module")
def chains():
    src = NoiseSource(704, 480, seed=4)
    j = jchain.AudioChain(jget_mode("m"), RATE, W, src)
    t = tchain.AudioChain(tget_mode("m"), RATE, W, src)
    jw = j.fm_win_config(j.fm_mono, NLINES)
    tw = t.fm_win_config(t.fm_mono, NLINES, "cpu")
    return j, t, jw, tw


@pytest.fixture(scope="module")
def fm(chains):
    """Both packages' FM statics as their encoders make them (no
    magnitude decay), and the JAX functions jitted once."""
    j, t, jw, tw = chains
    jfs = jsynth.make_fm_statics(j.fm_mono.num, j.fm_mono.den,
                                 j.fm_mono.level_int, j.fm_mono.kd, W,
                                 j.nseg, j.fm_mono.eps)
    tfs = tsynth.make_fm_statics(t.fm_mono.num, t.fm_mono.den,
                                 t.fm_mono.level_int, t.fm_mono.kd, W,
                                 t.nseg, t.fm_mono.eps,
                                 device="cpu")

    @jax.jit
    def jprep(d):
        held = jsynth.held_device(j.fm_mono, d["pcm"], jchain._LIM_HIST)
        return jsynth.fm_prepare(
            jw, jfs, NLINES, held, d["xa"], d["lens_off"], d["offq"],
            d["offr"], d["col0"], d["ctab"], d["stab"], d["cyc_base"],
            adv=d["adv"])

    @jax.jit
    def jstep(d):
        """fm_prepare and fm_add in one compiled step, as the JAX
        encoder runs them (XLA contracts more products there than in an
        fm_add compiled on its own)."""
        args, _ = jprep(d)
        z = jnp.zeros((NLINES, W), jnp.float32)
        return jsynth.fm_add(jfs, z, z, *args)

    return jfs, tfs, jprep, jstep


def _noise(n, seed):
    return np.random.default_rng(seed).integers(-32768, 32768, n)


@pytest.mark.parametrize("seed", [0, 1])
def test_limiter_device_process_exact(chains, seed):
    j, t, _, _ = chains
    x = _noise(6000, seed)
    x[1000:1400] = 32767                     # held over level
    host = t.fm_mono.limiter.process(x)
    dev = t.fm_mono.limiter.device_process(torch.as_tensor(x)).numpy()
    ref = np.asarray(j.fm_mono.limiter.device_process(jnp.asarray(x)))
    assert np.array_equal(dev, ref)
    assert np.array_equal(dev.astype(np.int64), host)


def test_held_device_exact(chains):
    j, t, _, _ = chains
    pcm = np.stack([_noise(5000, 3), _noise(5000, 4)], 1).astype(np.int32)
    ref = np.asarray(jsynth.held_device(j.fm_mono, jnp.asarray(pcm), 256))
    got = tsynth.held_device(t.fm_mono, torch.as_tensor(pcm), 256).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("n,bound", [(100, 1 << 20), (9152, 32767 * 422 + 1),
                                     (300_000, 5000)])
def test_cumsum_mod_exact(n, bound):
    """Direct (n <= C) and hierarchical (n > C, twice nested for the
    largest case) branches."""
    M = 17_694_180
    x = np.random.default_rng(n).integers(-bound + 1, bound, n).astype(
        np.int32)
    got = tsynth._cumsum_mod(torch.as_tensor(x), M, bound)
    assert got.dtype == torch.int32
    ref = np.asarray(jsynth._cumsum_mod(jnp.asarray(x), M, bound))
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy(), np.cumsum(x.astype(np.int64)) % M)


def _prepare_both(chains, fm, k0):
    """(JAX fm_prepare outputs, JAX anchor, port outputs, port anchor,
    the JAX per-block upload)."""
    j, t, jw, tw = chains
    _, tfs, jprep, _ = fm
    dj, i0j, i0nj = j.fm_compact_block_dev(j.fm_mono, k0, NLINES, jw,
                                           jnp.int32(12345))
    dt, i0t, i0nt = t.fm_compact_block_dev(
        t.fm_mono, k0, NLINES, tw, torch.tensor(12345, dtype=torch.int32))
    assert (i0j, i0nj) == (i0t, i0nt)
    dj = {k: jnp.asarray(v) for k, v in dj.items()}
    jargs, jxa = jprep(dj)
    held = tsynth.held_device(t.fm_mono, torch.as_tensor(dt["pcm"]),
                              tchain._LIM_HIST)
    targs, txa = tsynth.fm_prepare(
        tw, tfs, NLINES, held, dt["xa"], dt["lens_off"], dt["offq"],
        dt["offr"], *(torch.as_tensor(dt[k]) for k in ("col0", "ctab",
                                                        "stab")),
        adv=dt["adv"])
    return jargs, jxa, targs, txa, dj


@pytest.mark.parametrize("k0", [0, 1, 7 * NLINES + 1])
def test_fm_prepare_exact(chains, fm, k0):
    """The port keeps the segment phase as a count and its f32 unit
    (fm_add fuses their product; rounded, they are JAX's seg_base), and
    the carrier rotation as one period of lines (tiled, JAX's c0, s0)."""
    jargs, jxa, targs, txa, _ = _prepare_both(chains, fm, k0)
    assert int(txa) == int(jxa)
    seg_val, seg_cnt, seg_col, ctab, stab, unit = targs
    seg_base = seg_cnt * unit
    c0, s0 = (tsynth.tile_rows(t[:, None], NLINES)[:, 0]
              for t in (ctab, stab))
    names = ("seg_val", "seg_base", "seg_col", "c0", "s0")
    for name, a, b in zip(names, (seg_val, seg_base, seg_col, c0, s0),
                          jargs):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("k0", [1, 7 * NLINES + 1])
def test_fm_add_within_one_lsb(chains, fm, k0):
    """Byte-equal to the JAX encoder's compiled fm_prepare + fm_add."""
    _, tfs, _, jstep = fm
    _, _, targs, _, dj = _prepare_both(chains, fm, k0)
    ji, jq = map(np.asarray, jstep(dj))
    zeros = torch.zeros((NLINES, W), dtype=torch.float32)
    ti, tq = (a.numpy() for a in tsynth.fm_add(tfs, zeros, zeros, *targs))
    for name, a, b in (("I", ti, ji), ("Q", tq, jq)):
        flips = int(np.count_nonzero(a != b))
        assert a.tobytes() == b.tobytes(), \
            f"fm_add {name}: {flips} of {a.size} samples differ"


def _libm_f32(name):
    import ctypes
    import ctypes.util
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float]
    return fn


@pytest.mark.parametrize("lo,hi", [(-4.77, 11.12), (-120.0, 120.0),
                                   (-1e-3, 1e-3)])
def test_sincosf_glibc_equals_libm(lo, hi):
    """_sincosf_glibc against this process's libm sinf/cosf (which the
    JAX CPU backend calls) on seeded inputs: fm_add's phase range, the
    whole fast-reduction range and the tiny-argument paths."""
    n = 1_000_000 if lo == -4.77 else 200_000
    x = np.random.default_rng(int(hi * 100)).uniform(lo, hi, n).astype(
        np.float32)
    x[:4] = (0.0, -0.0, 0.75, -0.75)
    s, c = (a.numpy() for a in tsynth._sincosf_glibc(torch.from_numpy(x)))
    sinf, cosf = _libm_f32("sinf"), _libm_f32("cosf")
    ref_s = np.fromiter(map(sinf, x.tolist()), np.float32, n)
    ref_c = np.fromiter(map(cosf, x.tolist()), np.float32, n)
    assert np.count_nonzero(s != ref_s) == 0
    assert np.count_nonzero(c != ref_c) == 0


def test_sincosf_glibc_refuses_large_input():
    with pytest.raises(RuntimeError):
        tsynth._sincosf_glibc(torch.tensor([1.0, 120.0]))
    with pytest.raises(RuntimeError):
        tsynth._sincosf_glibc(torch.tensor([float("nan")]))
