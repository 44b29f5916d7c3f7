"""AM sound and A2 (Zweikanalton) stereo against hacktv_tpu, on the CPU.

The host audio bookkeeping (AM gain segments, the A2 carriers' held
values, the pilot's phase bases, the host-assembled FM block) equals the
JAX package's; whole encoders with AM sound (405-line system A, SECAM-L
with NICAM off) and with A2 (PAL-B/G and PAL-I at 16 MS/s, system M with
its L-R `a2m` carrier at 13.5135 MS/s) are byte-identical to
`hacktv_tpu.Encoder`, whose compiled step is the oracle for every fused
multiply-add, over sequential one-frame blocks 0-2; the command line's
frames equal the port's Encoder blocks; and statics carried between two
encoders leave the output unchanged.  Inputs come from seeds."""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu.audio import chain as jchain
from hacktv_tpu.config import get_mode as jget_mode
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import cli, convert
from hacktv_tpu_torch.audio import chain as tchain
from hacktv_tpu_torch.av.noise import NoiseSource
from hacktv_tpu_torch.config import get_mode as tget_mode

CONFIGS = {
    "a": ("a", 16_000_000, {}),
    "l-am": (replace(tget_mode("l"), nicam_level=0.0), 16_000_000, {}),
    "g-a2": ("g", 16_000_000, {"a2stereo": True}),
    "g-a2-direct": ("g", 16_000_000, {"a2stereo": True,
                                      "fm_direct_trig": True}),
    "i-a2": ("i", 16_000_000, {"a2stereo": True}),
    "m-a2": ("m", 13_513_500, {"a2stereo": True}),
}
BLOCKS = 3
_JAX: dict = {}


def _jconf(mode):
    """The JAX package's VidConfig for a port mode or VidConfig."""
    if isinstance(mode, str):
        return jget_mode(mode)
    return replace(jget_mode("l"), nicam_level=mode.nicam_level)


def _chains(mode, rate, seed, **kw):
    """The port's and the JAX package's AudioChain on one noise source."""
    t = TEncoder(mode, rate, device="cpu", **kw)
    src = NoiseSource(t.params.active_width, t.conf.active_lines, seed=seed)
    W = t.params.width
    return (tchain.AudioChain(t.conf, rate, W, src, **kw),
            jchain.AudioChain(_jconf(mode), rate, W, src, **kw), t)


# -- host bookkeeping ------------------------------------------------------------
@pytest.mark.parametrize("mode", ["a", "l"])
def test_am_block_equal(mode):
    t, j, enc = _chains(mode, 16_000_000, 3)
    nl = enc.params.lines
    for k0 in (0, 1, 7 * nl + 1):
        tb = t.am_block(t.am_mono, k0, nl)
        jb = j.am_block(j.am_mono, k0, nl)
        tc.assert_same(tb, {k: jb[k] for k in ("seg_val", "seg_col", "c0",
                                                "s0")}, f"am_block({k0})")


@pytest.mark.parametrize("mode,rate", [("g", 16_000_000),
                                       ("m", 13_513_500)])
def test_pilot_and_held_values_equal(mode, rate):
    """pilot_block over three sequential blocks (its anchor chains), and
    both A2 carriers' held values (two limiters, the 0.95 scale, system
    M's mono - right)."""
    t, j, enc = _chains(mode, rate, 4, a2stereo=True)
    nl = enc.params.lines
    for k0 in (0, nl, 2 * nl):
        tc.assert_same(t.pilot_block(k0, nl), j.pilot_block(k0, nl),
                       f"pilot_block({k0})")
    for name in ("fm_mono", "fm_right"):
        tc.assert_same(getattr(t, name).channel, getattr(j, name).channel)
        for lo, hi in ((-5, 300), (4000, 9000)):
            tc.assert_same(t._held_values(getattr(t, name), lo, hi),
                           j._held_values(getattr(j, name), lo, hi),
                           f"{name} held [{lo}, {hi})")


def test_host_fm_block_equal():
    """The host-assembled FM block (system M at 13.5135 MS/s, whose phase
    modulus is not exact) over sequential blocks: the anchored phase
    bases included."""
    t, j, enc = _chains("m", 13_513_500, 5)
    nl = enc.params.lines
    for k0 in (0, nl, 2 * nl):
        tb = t.fm_block(t.fm_mono, k0, nl)
        jb = j.fm_block(j.fm_mono, k0, nl)
        tc.assert_same(tb, {"seg_val": jb["seg_val"],
                            "seg_base": jb["seg_base"],
                            "seg_col": jb["seg_col"], "ctab": jb["c0"],
                            "stab": jb["s0"]}, f"fm_block({k0})")


# -- whole encoders ------------------------------------------------------------
def _jax_blocks(name):
    """The JAX encoder's blocks 0..BLOCKS-1, computed once per config."""
    if name not in _JAX:
        mode, rate, kw = CONFIGS[name]
        p = TEncoder(mode, rate, device="cpu").params
        src = NoiseSource(p.active_width, p.conf.active_lines, seed=7)
        j = JEncoder(_jconf(mode), rate, source=src, **kw)
        _JAX[name] = (j, src, [j.encode_block(b) for b in range(BLOCKS)])
    return _JAX[name]


def _check(name, got, ref, block):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    snr, maxerr, ndiff = tc.error_report(got, ref)
    msg = (f"{name} block {block}: SNR {snr:.1f} dB, max error {maxerr}, "
           f"{ndiff} of {ref.size} values differ")
    assert ndiff == 0 and maxerr == 0 and snr == np.inf, msg


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_matches_jax(name):
    mode, rate, kw = CONFIGS[name]
    _, src, ref = _jax_blocks(name)
    t = TEncoder(mode, rate, source=src, device="cpu", **kw)
    for b in range(BLOCKS):
        _check(name, t.encode_block(b), ref[b], b)


@pytest.mark.parametrize("argv,mode,kw", [
    (["-m", "l"], "l", {}),
    (["-m", "g", "--a2stereo"], "g", {"a2stereo": True}),
])
def test_cli_matches_encoder(tmp_path, argv, mode, kw):
    """Two frames from the command line, as one two-frame block."""
    out = tmp_path / "out.bin"
    assert cli.main(argv + ["--frames", "2", "--device", "cpu", "-o",
                            str(out), "test"]) == 0
    ref = TEncoder(mode, 16_000_000, frames_per_block=2, device="cpu",
                   **kw).encode_block(0)
    assert out.stat().st_size == 2 * 640_000 * 2 * 2
    assert out.read_bytes() == ref.tobytes()


def _jax_statics(j) -> dict:
    """The JAX encoder's SECAM, AM and A2 statics under convert.py's
    names."""
    out = {}
    if j.secam_statics is not None:
        st = j.secam_statics
        for f in convert.SECAM_FIELDS:
            out["secam_statics." + f] = np.asarray(getattr(st, f))
        dc = j.secam_statics._dev_consts
        for f in convert.SECAM_CONST_FIELDS:
            out["secam_statics." + f] = dc[f]
    if j.am_statics is not None:
        out["am_statics.cos_x"] = j.am_statics.cos_x
        out["am_statics.sin_x"] = j.am_statics.sin_x
    if j.fm_right_statics is not None:
        out["fm_right_statics.cos_x"] = j.fm_right_statics.cos_x
        out["fm_right_statics.sin_x"] = j.fm_right_statics.sin_x
        out["fm_right_win.lens_tiled"] = j.fm_right_win.lens_tiled
        for f in convert.A2_FIELDS:
            out["a2_statics." + f] = getattr(j.a2_statics, f)
    return out


@pytest.mark.parametrize("mode,kw", [("l", {}), ("g", {"a2stereo": True})])
def test_statics_carry_over(mode, kw):
    """SECAM-L (SECAM, AM and NICAM statics) and PAL-B/G with A2: the
    statics equal the JAX encoder's under convert.py's names, and a
    second port encoder with them installed gives the same blocks."""
    rate = 16_000_000
    p = TEncoder(mode, rate, device="cpu").params
    src = NoiseSource(p.active_width, p.conf.active_lines, seed=9)
    j = JEncoder(mode, rate, source=src, **kw)
    ref = [j.encode_block(b) for b in range(2)]
    t = TEncoder(mode, rate, source=src, device="cpu", **kw)
    arrays = convert.statics_to_numpy(t)
    tc.assert_same({k: arrays[k] for k in _jax_statics(j)},
                   _jax_statics(j), "statics")
    other = TEncoder(mode, rate, source=src, device="cpu", **kw)
    convert.statics_from_numpy(other, arrays)
    tc.assert_same(convert.statics_to_numpy(other), arrays, "installed")
    for b in range(2):
        _check(f"{mode} (carried statics)", other.encode_block(b), ref[b],
               b)
