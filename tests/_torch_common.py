"""Helpers shared by the tests that hold hacktv_tpu_torch against
hacktv_tpu (tests/test_torch_*.py)."""

from __future__ import annotations

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
