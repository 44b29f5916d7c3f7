"""Helpers shared by the tests that hold hacktv_tpu_torch against
hacktv_tpu (tests/test_torch_*.py)."""

from __future__ import annotations

import ctypes as C
import dataclasses
import enum
import fcntl
import os
import tempfile
import time

import numpy as np
import torch

# the tier-1 run uses several workers: keep torch to two threads each
torch.set_num_threads(2)


def assert_same(a, b, path="value"):
    """Deep equality of a port value `a` and a JAX-package value `b`:
    arrays equal in dtype, shape and bytes; enums by name and value;
    dataclasses field by field."""
    if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
        a = np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} != {b.dtype}"
        assert a.shape == b.shape, f"{path}: shape {a.shape} != {b.shape}"
        assert a.tobytes() == b.tobytes(), f"{path}: values differ"
    elif isinstance(b, enum.Enum):
        assert (type(a).__name__, a.name, a.value) == \
            (type(b).__name__, b.name, b.value), f"{path}: {a} != {b}"
    elif dataclasses.is_dataclass(b):
        fa = [f.name for f in dataclasses.fields(a)]
        fb = [f.name for f in dataclasses.fields(b)]
        for name in fb:
            assert name in fa, f"{path}: port lacks field {name}"
            assert_same(getattr(a, name), getattr(b, name),
                        f"{path}.{name}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(b, dict):
        assert set(a) == set(b), f"{path}: keys differ"
        for k in b:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif hasattr(b, "num") and hasattr(b, "den"):      # Rational
        assert (a.num, a.den) == (b.num, b.den), f"{path}: {a} != {b}"
    else:
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


def error_report(got: np.ndarray, ref: np.ndarray):
    """(SNR in dB, max |error|, count of differing samples)."""
    g = got.astype(np.int64)
    r = ref.astype(np.int64)
    d = g - r
    noise = float(np.sum(d.astype(np.float64) ** 2))
    sig = float(np.sum(r.astype(np.float64) ** 2))
    snr = np.inf if noise == 0 else 10.0 * np.log10(sig / noise)
    return snr, int(np.abs(d).max()), int(np.count_nonzero(d))


def jax_runtime():
    """The JAX package's native runtime, loaded before any JAX encoder that
    uses it is built.  Its loader builds the library into native/ with
    make, and test processes running side by side may build it at the
    same time; a load that meets a half-written library is retried (the
    loader keeps its first error, so that is cleared first).  A JAX
    FM-video encoder whose runtime failed to load would quietly take its
    device closed form instead of the host-exact path it is compared
    with."""
    from hacktv_tpu import runtime as jrt
    lock = os.path.join(tempfile.gettempdir(), "hacktv_rt_test_build.lock")
    with open(lock, "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        for _ in range(5):
            try:
                return jrt.load()
            except Exception:
                jrt._load_error = None
                time.sleep(2)
        return jrt.load()


class MovingSource:
    """A moving source from a seed: `nframes` distinct RGB frames (a
    gradient shifted 24 pixels a frame, with seeded noise), the last held
    after the end, int16 stereo noise for sound, and one CEA-608 pair a
    frame.  `saturated` frames are saturated colours, one a frame, which
    drive the SECAM carrier's phase past 120 rad.  Not
    stateless: the encoders take the moving path."""

    interlaced = 0

    def __init__(self, width: int, height: int, nframes: int = 12,
                 seed: int = 5, saturated: bool = False):
        self.width, self.height = width, height
        rng = np.random.default_rng(seed)
        x = np.arange(width)[None, :, None]
        y = np.arange(height)[:, None, None]
        if saturated:
            # whole frames of one colour each; cyan and green take the
            # carrier's phase past 120 rad within a line
            cols = np.array([[0, 255, 255], [0, 255, 0], [255, 255, 0],
                             [0, 0, 255]], np.uint8)
            self.frames = [np.broadcast_to(cols[f % 4], (height, width, 3)
                                           ).copy() for f in range(nframes)]
        else:
            self.frames = [np.clip(
                (x + 24 * f) % 256 * np.array([1.0, 0.5, 0.25])
                + (y % 64) + rng.integers(0, 32, (height, width, 3)),
                0, 255).astype(np.uint8) for f in range(nframes)]
        self.noise = rng.integers(-20000, 20000, (32000 * 4, 2)
                                  ).astype(np.int16)

    def read_video(self, frame_no: int) -> np.ndarray:
        return self.frames[min(frame_no, len(self.frames) - 1)]

    def read_audio(self, start: int, count: int) -> np.ndarray:
        idx = (start + np.arange(count)) % len(self.noise)
        return self.noise[idx]

    def read_cc608(self, frame_no: int):
        return 0x41 + frame_no % 26, 0x61 + frame_no % 26


def pickled_modules(blob: bytes) -> set:
    """The modules whose classes or functions a pickle refers to."""
    import io
    import pickle
    mods = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            mods.add(module)
            return super().find_class(module, name)
    Recorder(io.BytesIO(blob)).load()
    return mods


def assert_no_torch(blob: bytes) -> None:
    """A checkpoint holds numpy and plain Python values only: no torch
    tensor, no device."""
    mods = pickled_modules(blob)
    bad = sorted(m for m in mods if m == "torch" or m.startswith("torch."))
    assert not bad, f"the blob refers to {bad}"


class MockVendorLib:
    """A vendor library (libhackrf, libSoapySDR, libosmo-fl2k) for either
    package's drivers: every function returns success (0) and is recorded
    in `called`, in order.  writeStream takes at most `chunk` samples a
    call and keeps them in `written`.  With a `transfer` size, the TX
    callback that hackrf_start_tx or fl2k_start_tx receives is pulled at
    hackrf_stop_tx or fl2k_stop_tx into `pulled`: HackRF transfers of
    `transfer` bytes until the callback ends the stream (at most
    `max_transfers`), or `max_transfers` FL2K transfers of `transfer`
    samples (R, G, B)."""

    def __init__(self, version=b"git-abcdef (2024)", chunk=1000,
                 transfer=0, max_transfers=64):
        self.called = []
        self.written = []
        self.pulled = []
        self._version = version
        self._chunk = chunk
        self._transfer = transfer
        self._max = max_transfers
        self._cb = None

    def _pull_hackrf(self):
        # the callback's own structure type (each package has its own)
        t = self._cb.argtypes[0]._type_()
        buf = (C.c_uint8 * self._transfer)()
        t.buffer = C.cast(buf, C.POINTER(C.c_uint8))
        t.buffer_length = t.valid_length = self._transfer
        for _ in range(self._max):
            if self._cb(C.pointer(t)) != 0:
                return
            self.pulled.append(bytes(buf))
        raise RuntimeError("the HackRF callback did not end the stream")

    def _pull_fl2k(self):
        info = self._cb.argtypes[0]._type_()
        n = info.len = self._transfer
        for _ in range(self._max):
            self._cb(C.pointer(info))
            self.pulled.append(tuple(C.string_at(getattr(info, f), n)
                                     for f in ("r_buf", "g_buf", "b_buf")))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def fn(*args):
            self.called.append(name)
            if name == "hackrf_version_string_read":
                args[1].value = self._version
            if name == "hackrf_open_by_serial":
                args[1]._obj.value = 1234
            if name == "fl2k_open":
                args[0]._obj.value = 1234
            if name in ("SoapySDRDevice_makeStrArgs",
                        "SoapySDRDevice_setupStream"):
                return 1234
            if name == "hackrf_compute_baseband_filter_bw":
                return 1_750_000
            if name == "SoapySDRDevice_writeStream":
                n = min(args[3], self._chunk)
                self.written.append(C.string_at(args[2][0], n * 4))
                return n
            if name in ("hackrf_start_tx", "fl2k_start_tx"):
                self._cb = args[1]
            if name == "hackrf_stop_tx" and self._transfer:
                self._pull_hackrf()
            if name == "fl2k_stop_tx" and self._transfer:
                self._pull_fl2k()
            return 0
        setattr(self, name, fn)
        return fn
