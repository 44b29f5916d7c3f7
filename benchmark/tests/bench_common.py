"""Shared by the benchmark's tests: the benchmark's folder and the repo's
root on sys.path, the `card` fixture, cells listed or kept, and cells shrunk to one frame a
block for runs on the CPU.  Import it before `run` or `harness`."""

from __future__ import annotations

import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run  # noqa: E402
from harness.manifest import cell, kept_cell, load_manifest  # noqa: E402

SEED = 2**31 + 977


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def any_cell(name: str) -> dict:
    """Cell `name` of BENCHMARK.json, or <config>.<traffic> of a
    configuration kept in configs/ that no listed cell runs."""
    man = load_manifest()
    if name in {w["name"] for w in man["workloads"]}:
        return cell(man, name)
    return kept_cell(man, *name.rsplit(".", 1))


def small_cell(name: str, fpb: int = 1) -> dict:
    c = any_cell(name)
    c["mix"] = dict(c["mix"], frames_per_block=fpb)
    return c


def run_small(name: str, seconds: float = 0.5, seed: int = SEED,
              **kw) -> dict:
    """run.run_cell of cell `name` on the CPU at one frame a block."""
    return run.run_cell(small_cell(name), seed, seconds, False,
                        device="cpu", t_start=time.perf_counter(), **kw)
