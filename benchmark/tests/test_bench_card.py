"""A run of each cell on the card, as the benchmark's command makes it,
with a short window: the result line's keys, and `correct`.  A
configuration kept in configs/ that no listed cell runs is run through
run_cell at its full size."""

import json
import time

import pytest

from bench_common import SEED, any_cell, card  # noqa: F401  (the fixture)
from harness.manifest import load_manifest
import run

LISTED = {w["name"] for w in load_manifest()["workloads"]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pal-i-vsb.testcard",
                                  "pal-fm-preemph.testcard"])
def test_run_on_the_card(card, capsys, name):
    if name not in LISTED:
        out = run.run_cell(any_cell(name), SEED, 2.0, False,
                           t_start=time.perf_counter())
        assert out["correct"], out["check"]
        assert out["device"]["platform"] == "gpu"
        return
    assert run.main(["--workload", name, "--seed", str(SEED),
                     "--seconds", "2", "--trace", "0"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {"samples_per_s", "setup_s"}
