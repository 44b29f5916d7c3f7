"""Print how far hacktv_tpu_torch is from hacktv_tpu on the CPU: the
counts that tests/test_torch_*.py hold to their bars, as numbers.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py --sincosf 10000000

Sections: the stream FIR's first-step rule over random tap sets, the
glibc sin/cos emulation against this process's libm over seeded inputs in
fm_add's phase range and, through glibc's large-argument reduction, over
|x| in [120, 1e5] (FM video's phases), the FM carrier against the JAX encoder's compiled
fm_prepare + fm_add (NTSC-M, direct cos/sin) and against the JAX PAL-I
encoder with NICAM off (the K=4 rotation chain), the NICAM sign stream
and contribution against hacktv_tpu's device coder and nicam_add, the SECAM
chroma program against the JAX one (and the largest carrier phase the
test card and the field-identification lines give), and each encoder
configuration's first one-frame blocks (SNR, max error, differing
samples): two for the PAL and NTSC chains and the VBI services, three
(the SECAM IIR carry crossed twice) for SECAM, AM, A2, FM video, the RF
tail and SiS; and each VBI service's render bound with a seeded render
against the JAX package's."""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import functools
import os
import sys
from dataclasses import replace

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
from hacktv_tpu.audio import nicam_dev as jnd  # noqa: E402
from hacktv_tpu.audio import synth as jsynth  # noqa: E402
from hacktv_tpu.config import get_mode as jget_mode  # noqa: E402
from hacktv_tpu.ops import pallas_fir  # noqa: E402
from hacktv_tpu.video import params as jparams  # noqa: E402
from hacktv_tpu.video import raster as jraster  # noqa: E402
from hacktv_tpu.video import secam as jsecam  # noqa: E402
from hacktv_tpu_torch import Encoder as TEncoder  # noqa: E402
from hacktv_tpu_torch.audio import chain as tchain  # noqa: E402
from hacktv_tpu_torch.audio import nicam_dev as tnd  # noqa: E402
from hacktv_tpu_torch.audio import synth as tsynth  # noqa: E402
from hacktv_tpu_torch.av.noise import NoiseSource  # noqa: E402
from hacktv_tpu_torch.config import get_mode as tget_mode  # noqa: E402
from hacktv_tpu_torch.ops import stream_fir as sf  # noqa: E402
from hacktv_tpu_torch.video import secam as tsecam  # noqa: E402


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


def sincosf(n: int, lo: float = -4.77, hi: float = 11.12,
            large: bool = False) -> None:
    """hacktv_tpu_torch's glibc sinf/cosf against libm's own, which the
    JAX CPU backend calls; [lo, hi] covers the phases fm_add sees.  With
    `large`, |x| is log-uniform over [lo, hi] with either sign, through
    glibc's large-argument reduction (FM video's phases)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for f in (libm.sinf, libm.cosf):
        f.restype = ctypes.c_float
        f.argtypes = [ctypes.c_float]
    rng = np.random.default_rng(11)
    if large:
        x = (np.exp(rng.uniform(np.log(lo), np.log(hi), n))
             * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    else:
        x = rng.uniform(lo, hi, n).astype(np.float32)
    bad_s = bad_c = 0
    for a in range(0, n, 1 << 20):
        xb = x[a:a + (1 << 20)]
        s, c = (t.numpy() for t in tsynth._sincosf_glibc(
            torch.from_numpy(xb), large=large))
        xl = xb.tolist()
        bad_s += int(np.count_nonzero(
            s != np.fromiter(map(libm.sinf, xl), np.float32, len(xl))))
        bad_c += int(np.count_nonzero(
            c != np.fromiter(map(libm.cosf, xl), np.float32, len(xl))))
    span = f"|x| in [{lo}, {hi}]" if large else f"[{lo}, {hi}]"
    print(f"glibc sinf/cosf emulation: {n} inputs, {span}, sin "
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


def fm_chain() -> None:
    """PAL-I with NICAM off and the filter on: the FM carrier through the
    rotation chain on the filtered video, audio lines from 1 and from
    7*625+1."""
    src = NoiseSource(832, 576, seed=5)
    for block in (0, 7):
        j = JEncoder(replace(jget_mode("i"), nicam_level=0.0), 16_000_000,
                     vfilter=True, source=src)
        t = TEncoder(replace(tget_mode("i"), nicam_level=0.0), 16_000_000,
                     vfilter=True, source=src, device="cpu")
        snr, maxerr, ndiff = tc.error_report(t.encode_block(block),
                                             j.encode_block(block))
        print(f"fm_add rotation chain, k0={block * 625 + 1}: SNR {snr:.1f} "
              f"dB, max error {maxerr}, {ndiff} values differ")


def nicam() -> None:
    """signs_device against hacktv_tpu's (jitted) on seeded PCM at the
    one-frame block's shapes, and the whole NICAM contribution: Encoder
    "i" with FM off against the JAX encoder."""
    t = TEncoder("i", 16_000_000, device="cpu")
    tst = t.nicam_dev_statics
    jst = jnd.make_dev_statics(tst.nf_max, tst.L, tst.spp)
    jfn = jax.jit(functools.partial(jnd.signs_device, jst))
    bad = [0, 0, 0]
    for seed in range(8):
        pcm = np.random.default_rng(seed).integers(
            -32768, 32768, (tst.nf_max * 32 + 82, 2)).astype(np.int16)
        ref = jfn(jnp.asarray(pcm), jnp.int32(seed % 4), jnp.int32(seed),
                  jnp.int32(500), jnp.int32(40 * 364))
        got = tnd.signs_device(tst, torch.as_tensor(pcm),
                               torch.tensor(seed % 4, dtype=torch.int32),
                               seed, 500, 40 * 364)
        for i, (a, b) in enumerate(zip(got, ref)):
            bad[i] += int(np.count_nonzero(a.numpy() != np.asarray(b)))
    print(f"NICAM signs_device, 8 PCM seeds: signs_i {bad[0]}, signs_q "
          f"{bad[1]} of {8 * tst.L}, dsym {bad[2]} of 8 differ")
    src = NoiseSource(832, 576, seed=7)
    j = JEncoder(replace(jget_mode("i"), fm_mono_level=0.0), 16_000_000,
                 source=src)
    t = TEncoder(replace(tget_mode("i"), fm_mono_level=0.0), 16_000_000,
                 source=src, device="cpu")
    for b in range(2):
        snr, maxerr, ndiff = tc.error_report(t.encode_block(b),
                                             j.encode_block(b))
        print(f"NICAM contribution (PAL-I, FM off) block {b}: SNR "
              f"{snr:.1f} dB, max error {maxerr}, {ndiff} values differ")


def secam() -> None:
    """device_chroma_carrier against the JAX function jitted on its own,
    on the test card's SECAM planes, blocks 0-2 with their carried z; and
    the largest |phase| of the SECAM carrier over those rows (glibc's
    fast sin/cos path, which _sincosf_glibc reproduces, ends at 120)."""
    t = TEncoder("secam", 16_000_000, device="cpu")
    p, W = t.params, t.params.width
    j = jparams.VideoParams.create(jget_mode("secam"), 16_000_000, 0)
    _, u, v = jraster.rgb_to_yuv_host(j, t.source.read_video(0), True)
    js = jsecam.make_statics(j, 0, p.active_width)
    jfn = jax.jit(lambda m, u, v, z: jsecam.device_chroma_carrier(
        js, W, m, u, v, z))
    phase_max = 0.0
    orig = tsecam._sincosf_glibc

    def probe(x, **kw):
        nonlocal phase_max
        phase_max = max(phase_max, float(x.abs().max()))
        return orig(x, **kw)
    tsecam._sincosf_glibc = probe
    zj, zt = jnp.float32(0.0), torch.tensor(0.0)
    for b in range(3):
        nm = tsecam.block_meta(p, b * 625 - 1, 627, 625, 0, t.source.height)
        jo, zj = jfn({k: jnp.asarray(a) for k, a in nm.items()},
                     jnp.asarray(u), jnp.asarray(v), zj)
        to, zt = tsecam.device_chroma_carrier(
            t.secam, tsecam.meta_to_device(nm, "cpu"), torch.as_tensor(u),
            torch.as_tensor(v), zt)
        print(f"SECAM chroma program, block {b}: "
              f"{np.count_nonzero(to.numpy() != np.asarray(jo))} of "
              f"{to.numel()} samples differ, z carry "
              f"{'equal' if float(zt) == float(zj) else 'differs'}")
    print(f"SECAM carrier phase on the test card: max |phase| "
          f"{phase_max:.3f} rad")
    phase_max = 0.0
    fid = TEncoder(replace(tget_mode("secam"), secam_field_id=True),
                   16_000_000, device="cpu")
    for b in range(2):
        fid.encode_block(b)
    tsecam._sincosf_glibc = orig
    print(f"SECAM carrier phase with the field-ID lines: max |phase| "
          f"{phase_max:.3f} rad")


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DEMO_TTI = os.path.join(DATA, "demo.tti")
RAW_TT = "raw:" + os.path.join(DATA, "raw_tt_packets.bin")


def _tt_clock():
    return 1_200_000_000


def encoders() -> None:
    for mode, rate, kw in (
            ("m", 13_500_000, dict(vfilter=True)), ("m", 13_500_000, {}),
            ("pal", 16_000_000, dict(vfilter=True)), ("pal", 16_000_000, {}),
            ("i", 16_000_000, {}), ("i", 16_000_000, dict(vfilter=True)),
            ("i", 16_000_000, dict(fm_direct_trig=True)),
            ("g", 16_000_000, {}), ("secam", 16_000_000, {}),
            ("l", 16_000_000, {}), ("l", 16_000_000, dict(vfilter=True)),
            ("d", 16_000_000, {}), ("a", 16_000_000, {}),
            ("g", 16_000_000, dict(a2stereo=True)),
            ("m", 13_513_500, dict(a2stereo=True)),
            ("pal-fm", 16_000_000, {}),
            ("pal-fm", 20_250_000, dict(vfilter=True)),
            ("ntsc-fm", 20_250_000, dict(vfilter=True)),
            ("secam-fm", 16_000_000, {}),
            ("pal-fm", 16_000_000, dict(swap_iq=True)),
            ("i", 20_000_000, dict(offset=-2_250_000)),
            ("i", 20_000_000, dict(offset=2_250_000)),
            ("l", 16_000_000, dict(secam_exact=True)),
            ("apollo-fsc", 14_000_000, {}), ("cbs405", 9_000_000, {}),
            ("i", 16_000_000, dict(pixel_rate=14_750_000)),
            ("pal", 8_000_000, dict(pixel_rate=16_000_000)),
            ("pal-fm", 20_250_000, dict(pixel_rate=13_500_000)),
            ("pal", 16_000_000, dict(wss="auto")),
            ("pal", 16_000_000, dict(vits=True)),
            ("ntsc", 13_500_000, dict(vits=True)),
            ("pal", 13_513_500, dict(vits=True)),
            ("m", 13_513_500, dict(vits=True)),
            ("i", 16_000_000, dict(vitc=True)),
            ("m", 13_500_000, dict(vitc=True)),
            ("pal", 16_000_000, dict(acp=True)),
            ("ntsc", 13_500_000, dict(acp=True, cc608=True)),
            ("pal", 16_000_000, dict(teletext=DEMO_TTI,
                                     teletext_clock=_tt_clock)),
            ("pal", 16_000_000, dict(teletext=RAW_TT)),
            ("i", 16_000_000, dict(sis="dcsis")),
            ("i", 16_000_000, dict(vfilter=True, teletext=DEMO_TTI,
                                   teletext_clock=_tt_clock, wss="16:9",
                                   vits=True, vitc=True)),
            ("pal", 16_000_000, dict(vits=True, wss="auto", acp=True,
                                     vitc=True, cc608=True, sis="dcsis",
                                     teletext=DEMO_TTI,
                                     teletext_clock=_tt_clock))):
        probe = TEncoder(mode, rate, pixel_rate=kw.get("pixel_rate", 0),
                         device="cpu")
        src = NoiseSource(probe.params.active_width, probe.conf.active_lines,
                          seed=7)
        j = JEncoder(mode, rate, source=src, **kw)
        t = TEncoder(mode, rate, source=src, device="cpu", **kw)
        nb = 3 if mode in ("secam", "l", "d", "a") or mode.endswith(
            "-fm") or {"a2stereo", "offset", "sis"} & set(kw) else 2
        if mode in ("apollo-fsc", "cbs405"):
            nb = 4                          # every colour field
        for b in range(nb):
            snr, maxerr, ndiff = tc.error_report(t.encode_block(b),
                                                 j.encode_block(b))
            shown = {k: (os.path.basename(v) if k == "teletext" else v)
                     for k, v in kw.items() if k != "teletext_clock"}
            print(f"Encoder({mode!r}, {rate}, {shown}) block {b}: SNR "
                  f"{snr:.1f} dB, max error {maxerr}, {ndiff} values "
                  f"differ")


def vbi() -> None:
    """Each service's render bound: the largest partial sum of bits @
    basis against 2^24 (f32 exact), and a seeded render against the JAX
    package's."""
    from hacktv_tpu.services import vbidata as jvbi
    from hacktv_tpu_torch.services import vbidata as tvbi
    for mode, rate, kw in (("i", 16_000_000, dict(
            teletext=DEMO_TTI, wss="16:9", vitc=True, cc608=True,
            sis="dcsis")), ("m", 13_500_000, dict(vitc=True, cc608=True))):
        t = TEncoder(mode, rate, device="cpu", **kw)
        for svc in t.services:
            basis = getattr(svc, "basis", None)
            if basis is None:
                continue
            bits = (np.random.default_rng(1).random(
                (64, basis.shape[0])) < 0.5).astype(np.float32)
            got = tvbi.render(torch.as_tensor(bits), torch.as_tensor(basis))
            ref = np.asarray(jvbi.render(jnp.asarray(bits), basis))
            print(f"{type(svc).__name__} ({mode}, {rate}): largest partial "
                  f"sum {tvbi.sum_bound(basis):.0f} of 2^24, "
                  f"{int(np.count_nonzero(got.numpy() != ref))} of "
                  f"{ref.size} render values differ")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sincosf", type=int, default=1_000_000, metavar="N",
                    help="inputs for the sin/cos section")
    args = ap.parse_args()
    print(f"torch {torch.__version__}, threads {torch.get_num_threads()}, "
          f"jax {jax.__version__}")
    fir_rule()
    sincosf(args.sincosf)
    sincosf(args.sincosf, 120.0, 1e5, large=True)
    fm_flips()
    fm_chain()
    nicam()
    secam()
    vbi()
    encoders()
