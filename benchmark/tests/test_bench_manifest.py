"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by its name."""

import json
import os
import re

import pytest

import bench_common  # noqa: F401  (sys.path)
import run
from harness.manifest import (HERE, ROOT, cell, kept_cell, load_manifest,
                              reader)
from harness.program import cli_args

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
CONFIG_FILES = sorted(os.listdir(os.path.join(HERE, "configs")))
# configurations kept in configs/ that no listed cell runs (PERF.md §7)
KEPT = sorted(f[:-len(".json")]
              for f in os.listdir(os.path.join(HERE, "configs"))
              if "benchmark/configs/" + f not in {c["file"]
                                                  for c in MAN["configs"]})


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"][1] == "benchmark/run.py"
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_and_units():
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    names = ([c["name"] for c in MAN["configs"]] + CELLS
             + [m["name"] for m in metrics]
             + [w["traffic"] for w in MAN["workloads"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in (MAN["configs"], MAN["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert set(e2e) == {"samples_per_s", "setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] == "host_clock" for m in e2e.values())


def test_per_layer_metrics_move_an_end_to_end_metric():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert "\n" not in m["layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = cell(MAN, name)
    assert c["workload"]["chips"] == 1
    assert {"mode", "sample_rate", "vfilter", "check"} <= set(c["config"])
    assert {"kind", "frames_per_block", "warmup_blocks"} <= set(c["mix"])
    assert c["per_layer"] and len(c["end_to_end"]) == 2
    for m in c["per_layer"]:
        assert callable(reader(m["name"]))


def test_config_files_lie_under_paths():
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, f))
    assert os.path.isdir(os.path.join(HERE, "traffic"))


def test_kept_configs_found_by_name():
    assert KEPT == ["pal-fm-preemph"]
    for name in KEPT:
        c = kept_cell(MAN, name, "testcard")
        assert c["workload"]["name"] == name + ".testcard"
        assert {"mode", "sample_rate", "vfilter", "check"} <= set(c["config"])
        assert [m["name"] for m in c["end_to_end"]] == ["samples_per_s",
                                                        "setup_s"]
        with pytest.raises(SystemExit):
            cell(MAN, c["workload"]["name"])


@pytest.mark.parametrize("file", CONFIG_FILES)
def test_config_switches_and_reference(file):
    # `switches` parse with the CLI's parser and none is refused;
    # `reference` names a module under reference/ with `make` (without
    # either key: no switch, and the codec reference)
    with open(os.path.join(HERE, "configs", file)) as f:
        config = json.load(f)
    switches = config.get("switches", [])
    assert isinstance(switches, list)
    assert all(isinstance(s, str) for s in switches)
    args = cli_args(config, "cuda")
    assert args.mode == config["mode"]
    assert callable(run.reference_module(config).make)
