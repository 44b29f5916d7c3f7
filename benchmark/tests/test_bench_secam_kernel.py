"""The SECAM kernel's share of SECAM windows (metrics/secam_kernel_pct.py):
its arithmetic from the program's counters, and a traced run of the cell
on the card, whose every window runs the kernel."""

import importlib.util
import json
import os

import pytest

from bench_common import BENCH, SEED, card  # noqa: F401
import run

NAME = "secam-l-vsb.testcard"


def _reader():
    path = os.path.join(BENCH, "metrics", "secam_kernel_pct.py")
    spec = importlib.util.spec_from_file_location("secam_kernel_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("counters,want", [
    ({}, None),
    ({"secam.windows": 5}, None),
    ({"secam.kernel_windows": 0, "secam.windows": 0}, None),
    ({"secam.kernel_windows": 0, "secam.windows": 8}, 0.0),
    ({"secam.kernel_windows": 3, "secam.windows": 12}, 25.0),
    ({"secam.kernel_windows": 8, "secam.windows": 8}, 100.0)])
def test_secam_kernel_pct_arithmetic(counters, want):
    assert _reader().from_counters(counters) == want


@pytest.mark.cuda
def test_every_window_of_the_cell_runs_the_kernel(card, capsys):
    assert run.main(["--workload", NAME, "--seed", str(SEED),
                     "--seconds", "2", "--trace", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["metrics"]["secam_kernel_pct"]["value"] == 100.0
