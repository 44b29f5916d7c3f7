"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into
`_build/lib<name>.so` at first use and loaded with ctypes: the sources have
a plain C interface (device pointers, sizes and the CUDA stream), so the
build needs neither PyTorch's headers nor its C++ extension tools.  A library
older than its source is rebuilt.  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

from .. import telemetry

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "hacktv_tpu_torch/csrc at first use and need the "
                       "CUDA toolkit")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = lib_path(name)
    src = os.path.join(CSRC, f"{name}.cu")
    return not (os.path.exists(out)
                and os.path.getmtime(out) >= os.path.getmtime(src))


def build_all(names=None) -> dict:
    """Compile csrc/<name>.cu for every stale name (default: every source
    in csrc/), one nvcc process per source, all started together.
    Returns {name: nvcc's report (registers, shared memory, spills)} for
    the libraries built; raises if any build fails."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    names = [n for n in names if _stale(n)]
    if not names:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src = os.path.join(CSRC, f"{name}.cu")
        jobs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, lib_path(name))
            reports[name] = out
        else:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{out}")
        if os.path.exists(tmp):
            os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if needed, together
    with every other stale source (the builds run side by side)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with telemetry.span("setup.cuda_build"):
                build_all()
                lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
        return lib
