"""The native NICAM-728 frame coder (`rt_nicam_encode_frames`) against
hacktv_tpu on the CPU, byte for byte: the port's coder with `native=True`
and `native=False` against the JAX package's native path and its numpy
path (`_NO_NATIVE`), over the four modes, both `reserve` bits, frame
numbers across the C0 flag's wrap, 0 to 2,560 frames and PCM from full-
scale noise, silence, a square wave at the int16 limits and a ramp through
every scale factor; SiS's encoder with each coder against the JAX
encoder; and `$HACKTV_RT_DIR`, in a subprocess."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

import _torch_common as tc
from hacktv_tpu.audio import nicam as jnicam
from hacktv_tpu_torch import runtime
from hacktv_tpu_torch.audio import nicam as tnicam

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HIST = tnicam.J17_NTAPS - 1
STEREO, DUAL, MONO_DATA, DATA = (tnicam.MODE_STEREO, tnicam.MODE_DUAL_MONO,
                                 tnicam.MODE_MONO_DATA, tnicam.MODE_DATA)


def _pcm(kind: str, n_frames: int, seed: int = 13) -> np.ndarray:
    """int64 pairs [82 + 32 n_frames, 2] of int16 range, J.17's history
    rows first."""
    n = HIST + 32 * n_frames
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(-32768, 32768, (n, 2)).astype(np.int64)
    if kind == "silence":
        return np.zeros((n, 2), np.int64)
    if kind == "square":
        # +-32767 / -32768 in runs of 5 and 7 pairs, the channels apart
        t = np.arange(n)
        return np.stack([np.where(t // 5 % 2, 32767, -32768),
                         np.where(t // 7 % 2, -32768, 32767)],
                        axis=1).astype(np.int64)
    if kind == "ramp":
        # a frame's amplitude doubles frame to frame from 2^5 to full
        # scale and round again: J.17's output reaches every scale factor
        amp = np.minimum(32767, 1 << (5 + np.arange(n) // 32 % 11))
        s = rng.integers(-1 << 15, 1 << 15, (n, 2)) * amp[:, None] >> 15
        return s.astype(np.int64)
    raise ValueError(kind)


def _scale_factors(pcm: np.ndarray, n_frames: int) -> set:
    out = set()
    for ch in (0, 1):
        y = tnicam.j17_filter(pcm[:, ch])[HIST:HIST + 32 * n_frames]
        out |= set(tnicam.scale_factor_indices(y.reshape(n_frames, 32))
                   .tolist())
    return out


# id: (pcm, frames, first frame, mode, reserve)
CASES = {
    **{f"mode{m}-reserve{r}": ("noise", 256, 0, m, r)
       for m in (STEREO, DUAL, MONO_DATA, DATA) for r in (0, 1)},
    "first15": ("noise", 20, 15, STEREO, 0),
    "first16": ("noise", 20, 16, STEREO, 0),
    "first2^20+7": ("noise", 20, (1 << 20) + 7, STEREO, 0),
    "frames1": ("noise", 1, 0, STEREO, 0),
    "frames2": ("noise", 2, 3, STEREO, 0),
    "frames2560": ("noise", 2560, 0, STEREO, 0),
    "silence": ("silence", 40, 0, STEREO, 0),
    "square": ("square", 40, 0, STEREO, 0),
    "ramp": ("ramp", 44, 0, STEREO, 0),
}


@pytest.fixture(scope="module")
def jrt():
    """The JAX package's runtime, loaded under the test lock: a failed
    load would quietly turn its coder into numpy."""
    return tc.jax_runtime()


@pytest.mark.parametrize("case", list(CASES))
def test_coders_agree(case, jrt, monkeypatch):
    kind, n, first, mode, reserve = CASES[case]
    pcm = _pcm(kind, n)
    if kind == "ramp":
        assert _scale_factors(pcm, n) == set(range(1, 8))
    got = tnicam.encode_frames(pcm, first, mode, reserve)
    plain = tnicam.encode_frames(pcm, first, mode, reserve, native=False)
    jnative = jnicam._encode_frames_native(pcm, n, first, mode, reserve)
    assert jnative is not None, "the JAX coder did not take its native path"
    monkeypatch.setattr(jnicam, "_NO_NATIVE", True)
    jplain = jnicam.encode_frames(pcm, first, mode, reserve)
    assert got.shape == (n, 91) and got.dtype == np.uint8
    tc.assert_same(got, plain, "port native vs port numpy")
    tc.assert_same(got, jnative, "port native vs JAX native")
    tc.assert_same(got, jplain, "port native vs JAX numpy")


def test_no_frames(jrt, monkeypatch):
    """Fewer than 32 pairs past the history: both of the port's paths
    give uint8 (0, 91), as the JAX package's numpy path does (its native
    path returns None there)."""
    pcm = _pcm("noise", 1)[:HIST + 31]
    monkeypatch.setattr(jnicam, "_NO_NATIVE", True)
    want = jnicam.encode_frames(pcm, 7, STEREO, 0)
    assert want.shape == (0, 91)
    for native in (True, False):
        tc.assert_same(tnicam.encode_frames(pcm, 7, STEREO, 0,
                                            native=native), want,
                       f"native={native}")


def test_sis_encoder_native_matches_numpy_and_jax():
    """SiS on PAL-I at 16 MS/s, one-frame blocks 0-2: the encoder with the
    native coder (the default) equals the same encoder with the numpy
    coder and the JAX package's."""
    from _torch_vbi import encoders
    j, t = encoders("i", 16_000_000, {"sis": "dcsis"})
    _, u = encoders("i", 16_000_000, {"sis": "dcsis"})
    assert t.services[0].native and t.services[0].state.native
    u.services[0].native = False
    assert not u.services[0].state.native
    for b in range(3):
        ref = j.encode_block(b)
        tc.assert_same(t.encode_block(b), ref, f"native block {b}")
        tc.assert_same(u.encode_block(b), ref, f"numpy block {b}")


PROBE = r"""
import hashlib, importlib, os, sys
import numpy as np
from hacktv_tpu_torch import runtime
from hacktv_tpu_torch.audio import nicam
good, empty = sys.argv[1:]
assert runtime.LIB_PATH == os.path.join(good, "libhacktv_rt.so"), runtime.LIB_PATH
assert runtime.SRC_PATH == os.path.join(good, "hacktv_rt.cpp"), runtime.SRC_PATH
before = os.path.getmtime(runtime.LIB_PATH)
pcm = np.random.default_rng(3).integers(-32768, 32768, (82 + 32 * 64, 2))
a = nicam.encode_frames(pcm, 5, nicam.MODE_STEREO, 0)   # loads the library
assert runtime.build() is False
assert os.path.getmtime(runtime.LIB_PATH) == before
print("frames", a.shape, hashlib.sha256(a.tobytes()).hexdigest())
print("files", sorted(os.listdir(good)))
os.environ["HACKTV_RT_DIR"] = empty
importlib.reload(runtime)
try:
    nicam.encode_frames(pcm, 5, nicam.MODE_STEREO, 0)
except RuntimeError as e:
    print("empty raised:", e)
"""


@pytest.fixture(scope="module")
def rt_dir_probe(tmp_path_factory):
    """One process with `$HACKTV_RT_DIR` at a directory holding the source
    and a library touched newer (as tools/run_sanitizers.sh leaves a
    sanitized build), then, reloaded, at an empty one."""
    runtime.build()
    good = str(tmp_path_factory.mktemp("rt"))
    empty = str(tmp_path_factory.mktemp("rt_empty"))
    shutil.copy(os.path.join(ROOT, "native", "hacktv_rt.cpp"), good)
    shutil.copy(runtime.LIB_PATH, good)
    later = time.time() + 60
    os.utime(os.path.join(good, "libhacktv_rt.so"), (later, later))
    env = {**os.environ, "HACKTV_RT_DIR": good,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", PROBE, good, empty], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout, good, empty


def test_rt_dir_loads_its_library(rt_dir_probe):
    """The directory's library is loaded as it is: no build, no file
    added, and one NICAM call through it equals the numpy coder."""
    out, _, _ = rt_dir_probe
    pcm = np.random.default_rng(3).integers(-32768, 32768, (82 + 32 * 64, 2))
    want = tnicam.encode_frames(pcm, 5, STEREO, 0, native=False)
    assert (f"frames (64, 91) {hashlib.sha256(want.tobytes()).hexdigest()}"
            in out), out
    assert "files ['hacktv_rt.cpp', 'libhacktv_rt.so']" in out, out


def test_rt_dir_without_files_raises(rt_dir_probe):
    """A directory with neither file: the coder's load raises, naming
    it, and writes nothing there."""
    out, _, empty = rt_dir_probe
    assert f"empty raised: native runtime: neither {empty}" in out, out
    assert os.listdir(empty) == []
