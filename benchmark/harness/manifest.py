"""The benchmark's files, found by the names in BENCHMARK.json: a cell's
configuration (`file` of its config), its traffic mix
(traffic/<traffic>.json) and each per-layer metric's reader
(metrics/<name>.py, a function `read(ctx)`)."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(man: dict, name: str, root: str = ROOT) -> dict:
    """Workload `name` with its configuration, traffic mix and metrics
    (the end-to-end and per-layer entries it reports)."""
    wl = {w["name"]: w for w in man["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(wl))}")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    return _cell(man, w, os.path.join(root, cfg_entry["file"]))


def kept_cell(man: dict, config: str, traffic: str) -> dict:
    """A cell of configs/<config>.json under traffic/<traffic>.json that
    BENCHMARK.json does not list (a configuration kept for a later cell,
    PERF.md §7), with the metrics that every cell reports.  For the tests
    and the control; the benchmark's runs take only listed cells."""
    w = {"name": f"{config}.{traffic}", "config": config,
         "traffic": traffic, "chips": 1}
    return _cell(man, w, os.path.join(HERE, "configs", config + ".json"))


def _cell(man: dict, w: dict, config_file: str) -> dict:
    with open(config_file) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    reports = lambda m: w["name"] in m.get("workloads", [w["name"]])
    return {"workload": w, "config": config, "mix": mix,
            "end_to_end": [m for m in man["end_to_end"] if reports(m)],
            "per_layer": [m for m in man["per_layer"] if reports(m)]}


def reader(name: str):
    """metrics/<name>.py's `read`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
