"""The port's native runtime and the host-exact paths against hacktv_tpu,
on the CPU.

`hacktv_tpu_torch.runtime` builds native/hacktv_rt.cpp into the port's
own build directory.  Its exact FM carrier equals the JAX package's across
phase renormalisations, its file sink writes the bytes of the JAX
package's numpy writer, the per-sample held sound feed equals the JAX
package's, and the host-exact SECAM chroma and carrier equal the JAX
package's.  Whole encoders are byte-identical to `hacktv_tpu.Encoder`
over sequential one-frame blocks 0-2: the satellite FM modes (PAL-FM at
16 MS/s, with energy dispersal, with the CCIR-405 pre-emphasis filter at
20.25 MS/s, its 67 taps; NTSC-FM with its 71; SECAM-FM) and SECAM-L with
the host-exact chroma.  The command line's frames, written through the
native sink, equal the port's Encoder blocks.  The scramblers' native
recurrences (Videocrypt's cut bytes, Syster's PRBS event and shuffle
order) equal the port's plain Python versions.  Inputs come from seeds."""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np
import pytest

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu.audio import chain as jchain
from hacktv_tpu.config import get_mode as jget_mode
from hacktv_tpu.rf.file import FileSink as JFileSink
from hacktv_tpu.video import secam as jsecam
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import cli, convert, runtime
from hacktv_tpu_torch.audio import chain as tchain
from hacktv_tpu_torch.av.noise import NoiseSource
from hacktv_tpu_torch.config import get_mode as tget_mode
from hacktv_tpu_torch.ops import cuda_build
from hacktv_tpu_torch.video import raster
from hacktv_tpu_torch.video import secam as tsecam

BLOCKS = 3


@pytest.fixture(scope="module")
def jrt():
    """The JAX package's runtime, loaded before its encoders are built."""
    return tc.jax_runtime()


def test_library_is_built_into_the_port():
    runtime.load()
    assert os.path.dirname(runtime.LIB_PATH) == cuda_build.BUILD_DIR
    assert os.path.getmtime(runtime.LIB_PATH) >= os.path.getmtime(
        runtime.SRC_PATH)
    assert runtime.SRC_PATH.endswith(os.path.join("native", "hacktv_rt.cpp"))
    assert runtime.build() is False         # fresh: nothing to do


@pytest.mark.parametrize("freq,dev,rate,level", [
    (6_500_000.0, 50_000.0, 16_000_000, 1966),      # PAL-FM's sound
    (0.0, 16e6, 20_250_000, 32767)])                 # FM video itself
def test_fm_carrier_exact_matches_jax(jrt, freq, dev, rate, level):
    """Seeded samples over 100,000 outputs (three renormalisations), fed
    in uneven pieces, one of them without output; then a rewind."""
    from hacktv_tpu import runtime as jruntime
    rng = np.random.default_rng(int(freq) % 1000 + level)
    x = rng.integers(-32768, 32768, 100_000).astype(np.int16)
    j = jruntime.FmCarrierExact(freq, dev, rate, level)
    t = runtime.FmCarrierExact(freq, dev, rate, level)
    tc.assert_same(t._lut, j._lut, "lut")
    n = 0
    for size, emit in ((5000, True), (30000, False), (40000, True),
                       (25000, True)):
        a = t.process(x[n:n + size], n, emit=emit)
        b = j.process(x[n:n + size], n, emit=emit)
        if emit:
            tc.assert_same(a, b, f"carrier [{n}, {n + size})")
        else:
            assert a is None and b is None
        n += size
    tc.assert_same(t._state, j._state, "state")
    with pytest.raises(ValueError):
        t.process(x[:10], 5)
    t.reset()
    j.reset()
    tc.assert_same(t.process(x[:1000], 0), j.process(x[:1000], 0), "reset")


@pytest.mark.parametrize("dtype", ["uint8", "int8", "uint16", "int16",
                                   "int32", "float"])
@pytest.mark.parametrize("complex_out", [True, False])
def test_native_file_sink_bytes(tmp_path, dtype, complex_out):
    """Three seeded writes through the native sink against the JAX
    package's numpy writer (src/rf_file.c's formats)."""
    rng = np.random.default_rng(len(dtype) + complex_out)
    blocks = [rng.integers(-32768, 32768, (n, 2)).astype(np.int16)
              for n in (1000, 70_001, 3)]
    a, b = tmp_path / "native.bin", tmp_path / "numpy.bin"
    s = runtime.NativeFileSink(str(a), dtype, complex_out)
    f = JFileSink(str(b), dtype, complex_out)
    for blk in blocks:
        s.write(blk)
        f.write(blk)
    s.close()
    f.close()
    assert a.read_bytes() == b.read_bytes()


def test_native_file_sink_refuses_bad_path(tmp_path):
    with pytest.raises(OSError):
        runtime.NativeFileSink(str(tmp_path / "no" / "such" / "dir.bin"))


@pytest.mark.parametrize("mode,rate", [("pal-fm", 16_000_000),
                                       ("ntsc-fm", 20_250_000)])
def test_fm_exact_stream_equal(mode, rate):
    """The per-sample held feed of the FM-video modes' sound carrier over
    the stream start, a range inside one hold and a long range."""
    t = TEncoder(mode, rate, device="cpu")
    src = NoiseSource(t.params.active_width, t.conf.active_lines, seed=5)
    tch = tchain.AudioChain(t.conf, rate, t.params.width, src)
    jch = jchain.AudioChain(jget_mode(mode), rate, t.params.width, src)
    for n0, n1 in ((0, 5000), (123_457, 123_460), (800_000, 2_100_001)):
        tc.assert_same(tch.fm_exact_stream(tch.fm_mono, n0, n1),
                       jch.fm_exact_stream(jch.fm_mono, n0, n1),
                       f"fm_exact_stream({n0}, {n1})")
        tc.assert_same(tch.held_index(np.arange(n0, n1)),
                       jch.held_index(np.arange(n0, n1)), "held_index")


def test_secam_host_chroma_equal(jrt):
    """chroma_block_host (with and without its cache), its IIR state and
    carrier_addin_host for SECAM-L's block 1 rows (and the carried
    state), against the JAX package's functions."""
    t = TEncoder("l", 16_000_000, device="cpu")
    p = t.params
    st = t.secam.st
    jst = jsecam.make_statics(p, t.vframe_x, t.source.width)
    nl = p.lines
    nm = tsecam.block_meta(p, nl - 1, nl + 2, nl, t.vframe_y,
                           t.source.height)
    _, u, v = raster.rgb_to_yuv_host(p, t.source.read_video(0), True)
    W = p.width
    lut = tsecam.carrier_lut(st, p.pixel_rate)
    tc.assert_same(lut, jsecam.carrier_lut(jst, p.pixel_rate), "lut")
    state = (12.5, -3.25)
    cache: dict = {}
    for _ in range(2):          # the second call takes the cached FIR
        a = tsecam.chroma_block_host(st, W, nm, u, v, nl - 1, 2 * nl - 1,
                                     state, cache=cache)
        b = jsecam.chroma_block_host(jst, W, nm, u, v, nl - 1, 2 * nl - 1,
                                     state)
        tc.assert_same(a, b, "chroma_block_host")
    tc.assert_same(tsecam.carrier_addin_host(st, W, nm, a[0], lut),
                   jsecam.carrier_addin_host(jst, W, nm, b[0], lut),
                   "carrier_addin_host")


# -- whole encoders ---------------------------------------------------------------
_ED = lambda g: replace(g("pal-fm"), fm_energy_dispersal=0.0625)
# name: (JAX mode, port mode, sample rate, keyword arguments)
CONFIGS = {
    "pal-fm": ("pal-fm", "pal-fm", 16_000_000, {}),
    "pal-fm-ed": (_ED(jget_mode), _ED(tget_mode), 16_000_000, {}),
    "pal-fm-preemph": ("pal-fm", "pal-fm", 20_250_000, {"vfilter": True}),
    "ntsc-fm-preemph": ("ntsc-fm", "ntsc-fm", 20_250_000, {"vfilter": True}),
    "secam-fm": ("secam-fm", "secam-fm", 16_000_000, {}),
    "l-secam-exact": ("l", "l", 16_000_000, {"secam_exact": True}),
}
_JAX: dict = {}


def _jax_blocks(name):
    """The JAX encoder's blocks 0..BLOCKS-1, computed once per config."""
    if name not in _JAX:
        jmode, tmode, rate, kw = CONFIGS[name]
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


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_matches_jax(name):
    _, tmode, rate, kw = CONFIGS[name]
    j, src, ref = _jax_blocks(name)
    t = TEncoder(tmode, rate, source=src, device="cpu", **kw)
    if name != "l-secam-exact":
        # both take the host-exact FM video carrier
        assert j.fm_video_exact is not None and t.fm_video_exact is not None
    if "preemph" in name:
        assert len(t.vf_taps[0]) == (67 if tmode == "pal-fm" else 71)
    if t.secam is not None:
        assert not t.secam_device and not j.secam_device
    for b in range(BLOCKS):
        _check(name, t.encode_block(b), ref[b], b)


def test_fm_video_blocks_must_be_collected_in_order():
    t = TEncoder("pal-fm", 16_000_000, device="cpu")
    t.encode_block(0)
    d = [t.encode_block_device(b) for b in (1, 2)]
    with pytest.raises(RuntimeError, match="sequentially"):
        t.collect_block(2, d[1])


def test_statics_carry_over():
    """SECAM-FM (the host-exact carriers' and SECAM's LUTs) and PAL-FM
    with energy dispersal: the statics equal the JAX encoder's under
    convert.py's names, and a second port encoder with them installed
    gives the same blocks."""
    for name in ("secam-fm", "pal-fm-ed"):
        _, tmode, rate, kw = CONFIGS[name]
        j, src, ref = _jax_blocks(name)
        want = {n + "._lut": getattr(j, n)._lut
                for n in convert.FM_EXACT_ATTRS if getattr(j, n) is not None}
        if j._fm_ed_frame is not None:
            want["_fm_ed_frame"] = j._fm_ed_frame
        if j.secam_statics is not None:
            want["_secam_lut"] = j._secam_lut
        t = TEncoder(tmode, rate, source=src, device="cpu", **kw)
        arrays = convert.statics_to_numpy(t)
        tc.assert_same({k: arrays[k] for k in want}, want, name)
        other = TEncoder(tmode, rate, source=src, device="cpu", **kw)
        convert.statics_from_numpy(other, arrays)
        tc.assert_same(convert.statics_to_numpy(other), arrays, "installed")
        for b in range(2):
            _check(f"{name} (carried statics)", other.encode_block(b),
                   ref[b], b)


@pytest.mark.parametrize("argv,mode,rate,kw", [
    (["-m", "pal-fm", "--filter", "-s", "20250000"], "pal-fm", 20_250_000,
     {"vfilter": True}),
    (["-m", "i", "-s", "20000000", "--offset", "-2250000", "--swap-iq"],
     "i", 20_000_000, {"offset": -2_250_000, "swap_iq": True}),
    (["-m", "l", "--secam-exact", "-t", "uint8"], "l", 16_000_000,
     {"secam_exact": True}),
])
def test_cli_matches_encoder(tmp_path, argv, mode, rate, kw):
    """Two frames from the command line through the native sink, as one
    two-frame block of the port's Encoder (uint8: the sink's format of
    that block)."""
    out = tmp_path / "out.bin"
    assert cli.main(argv + ["--frames", "2", "--device", "cpu", "-o",
                            str(out), "test"]) == 0
    ref = TEncoder(mode, rate, frames_per_block=2, device="cpu",
                   **kw).encode_block(0)
    if "uint8" in argv:
        ref = ((ref.astype(np.int32) + 32768) >> 8).astype(np.uint8)
    assert out.read_bytes() == ref.tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_vc_clock16_matches_plain(seed):
    """rt_vc_clock16 through the port's loader against the port's Python
    recurrence (_VCState._clock16), 600 cut bytes from a seeded state."""
    from hacktv_tpu_torch.services.videocrypt import _VCState
    rng = np.random.default_rng(seed)
    sr1, sr2, c = (int(rng.integers(0, 1 << 31)),
                   int(rng.integers(0, 1 << 29)),
                   int(rng.integers(0, 1 << 16)))
    st = np.array([sr1, sr2, c], dtype=np.uint64)
    got = runtime.vc_clock16(st, 600)
    plain = _VCState((), ())
    plain.sr1, plain.sr2, plain.c = sr1, sr2, c
    want = np.array([plain._clock16() for _ in range(600)], np.uint8)
    tc.assert_same(got, want, "cut bytes")
    assert (int(st[0]), int(st[1]), int(st[2])) == \
        (plain.sr1, plain.sr2, plain.c)


@pytest.mark.parametrize("mode,key_table", [("premiere-fa", 0),
                                            ("cfrca", 0),
                                            ("ntvfa", 1)])
def test_ng_event_matches_plain(mode, key_table):
    """rt_ng_event through the port's loader against the port's Python
    recurrences (_NGState._prbs_update, _update_field_order): 40 chained
    events from the ECM's control word, each giving the same (s, r), LFSR
    state and 287-line order."""
    from hacktv_tpu_torch.services.syster import _NGState
    nat = _NGState(mode, syster=True, systercnr=False, key_table=key_table)
    plain = _NGState(mode, syster=True, systercnr=False,
                     key_table=key_table)
    for ng in (nat, plain):
        ng.cw = ng.ecm_cw
        ng._prbs_reset()
    for i in range(40):
        nat._event(7, 2)
        plain._event_plain()
        assert (nat.sr1, nat.sr2, nat.s, nat.r) == \
            (plain.sr1, plain.sr2, plain.s, plain.r), i
        tc.assert_same(np.asarray(nat.order, np.int64),
                       np.asarray(plain.order, np.int64), f"order {i}")
