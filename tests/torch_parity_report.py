"""Print how far hacktv_tpu_torch is from hacktv_tpu on the CPU: the
counts that tests/test_torch_*.py hold to their bars, as numbers.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py --sincosf 10000000

Sections: the stream FIR's first-step rule over random tap sets, the
glibc sin/cos emulation against this process's libm over seeded inputs in
fm_add's phase range, the FM carrier against the JAX encoder's compiled
fm_prepare + fm_add, and each encoder configuration's first two one-frame
blocks (SNR, max error, differing samples)."""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_common as tc  # noqa: E402
from hacktv_tpu import Encoder as JEncoder  # noqa: E402
from hacktv_tpu.audio import chain as jchain  # noqa: E402
from hacktv_tpu.audio import synth as jsynth  # noqa: E402
from hacktv_tpu.config import get_mode as jget_mode  # noqa: E402
from hacktv_tpu.ops import pallas_fir  # noqa: E402
from hacktv_tpu_torch import Encoder as TEncoder  # noqa: E402
from hacktv_tpu_torch.audio import chain as tchain  # noqa: E402
from hacktv_tpu_torch.audio import synth as tsynth  # noqa: E402
from hacktv_tpu_torch.av.noise import NoiseSource  # noqa: E402
from hacktv_tpu_torch.config import get_mode as tget_mode  # noqa: E402
from hacktv_tpu_torch.ops import stream_fir as sf  # noqa: E402


def fir_rule(sets: int = 24, nt: int = 11, n: int = 3000) -> None:
    bad = 0
    for seed in range(sets):
        rng = np.random.default_rng(seed)
        xs = (rng.standard_normal(n + nt - 1) * 20000).astype(np.float32)
        tr = rng.standard_normal(nt).astype(np.float32)
        ti = rng.standard_normal(nt).astype(np.float32)
        ji, jq = map(np.asarray, pallas_fir.stream_fir(jnp.asarray(xs), tr,
                                                       ti, n))
        pi, pq = (a.numpy() for a in sf.stream_fir(
            torch.from_numpy(xs), torch.from_numpy(tr),
            torch.from_numpy(ti), n))
        bad += int(np.count_nonzero(pi != ji) + np.count_nonzero(pq != jq))
    print(f"stream FIR: {2 * sets} random tap sets ({nt} taps, I and Q), "
          f"{bad} of {2 * sets * n} outputs differ from Pallas interpret")


def sincosf(n: int, lo: float = -4.77, hi: float = 11.12) -> None:
    """hacktv_tpu_torch's glibc sinf/cosf against libm's own, which the
    JAX CPU backend calls; [lo, hi] covers the phases fm_add sees."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for f in (libm.sinf, libm.cosf):
        f.restype = ctypes.c_float
        f.argtypes = [ctypes.c_float]
    x = np.random.default_rng(11).uniform(lo, hi, n).astype(np.float32)
    bad_s = bad_c = 0
    for a in range(0, n, 1 << 20):
        xb = x[a:a + (1 << 20)]
        s, c = (t.numpy() for t in tsynth._sincosf_glibc(
            torch.from_numpy(xb)))
        xl = xb.tolist()
        bad_s += int(np.count_nonzero(
            s != np.fromiter(map(libm.sinf, xl), np.float32, len(xl))))
        bad_c += int(np.count_nonzero(
            c != np.fromiter(map(libm.cosf, xl), np.float32, len(xl))))
    print(f"glibc sinf/cosf emulation: {n} inputs in [{lo}, {hi}], sin "
          f"{bad_s}, cos {bad_c} differ from libm")


def fm_flips() -> None:
    W, NL, rate = 858, 525, 13_500_000
    src = NoiseSource(704, 480, seed=4)
    j = jchain.AudioChain(jget_mode("m"), rate, W, src)
    t = tchain.AudioChain(tget_mode("m"), rate, W, src)
    jw = j.fm_win_config(j.fm_mono, NL)
    tw = t.fm_win_config(t.fm_mono, NL, "cpu")
    c = j.fm_mono
    jfs = jsynth.make_fm_statics(c.num, c.den, c.level_int, c.kd, W, j.nseg,
                                 c.eps)
    tfs = tsynth.make_fm_statics(c.num, c.den, c.level_int, c.kd, W, t.nseg,
                                 c.eps, device="cpu")

    @jax.jit
    def jrun(d):
        held = jsynth.held_device(j.fm_mono, d["pcm"], jchain._LIM_HIST)
        args = jsynth.fm_prepare(jw, jfs, NL, held, d["xa"], d["lens_off"],
                                 d["offq"], d["offr"], d["col0"], d["ctab"],
                                 d["stab"], d["cyc_base"])
        z = jnp.zeros((NL, W), jnp.float32)
        return jsynth.fm_add(jfs, z, z, *args)

    for k0 in (1, 7 * NL + 1):
        dj, _, _ = j.fm_compact_block_dev(j.fm_mono, k0, NL, jw,
                                          jnp.int32(12345))
        dt, _, _ = t.fm_compact_block_dev(
            t.fm_mono, k0, NL, tw, torch.tensor(12345, dtype=torch.int32))
        ji, jq = map(np.asarray, jrun({k: jnp.asarray(v)
                                       for k, v in dj.items()}))
        held = tsynth.held_device(t.fm_mono, torch.as_tensor(dt["pcm"]),
                                  tchain._LIM_HIST)
        args = tsynth.fm_prepare(
            tw, tfs, NL, held, dt["xa"], dt["lens_off"], dt["offq"],
            dt["offr"], torch.as_tensor(dt["col0"]),
            torch.as_tensor(dt["ctab"]), torch.as_tensor(dt["stab"]))
        z = torch.zeros((NL, W))
        ti, tq = (a.numpy() for a in tsynth.fm_add(tfs, z, z, *args))
        print(f"fm_add k0={k0}: I {np.count_nonzero(ti != ji)}, Q "
              f"{np.count_nonzero(tq != jq)} of {ti.size} samples flip, max "
              f"{max(np.abs(ti - ji).max(), np.abs(tq - jq).max()):.0f} LSB")


def encoders() -> None:
    for mode, rate, vf in (("m", 13_500_000, True), ("m", 13_500_000, False),
                           ("pal", 16_000_000, True),
                           ("pal", 16_000_000, False)):
        probe = TEncoder(mode, rate, device="cpu")
        src = NoiseSource(probe.params.active_width, probe.conf.active_lines,
                          seed=7)
        j = JEncoder(mode, rate, vfilter=vf, source=src)
        t = TEncoder(mode, rate, vfilter=vf, source=src, device="cpu")
        for b in range(2):
            snr, maxerr, ndiff = tc.error_report(t.encode_block(b),
                                                 j.encode_block(b))
            print(f"Encoder({mode!r}, {rate}, vfilter={vf}) block {b}: "
                  f"SNR {snr:.1f} dB, max error {maxerr}, {ndiff} samples "
                  f"differ")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sincosf", type=int, default=1_000_000, metavar="N",
                    help="inputs for the sin/cos section")
    args = ap.parse_args()
    print(f"torch {torch.__version__}, threads {torch.get_num_threads()}, "
          f"jax {jax.__version__}")
    fir_rule()
    sincosf(args.sincosf)
    fm_flips()
    encoders()
