"""Neither the reference nor the harness reaches for JAX or the JAX
package; the run's own look at sys.modules compares whole top-level
names."""

import ast
import os
import sys

import bench_common  # noqa: F401  (sys.path)
import run
from harness.manifest import HERE

BANNED = {"jax", "jaxlib", "flax", "hacktv_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _py_files(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_reference_imports_neither_jax_nor_either_package():
    for path in _py_files(os.path.join(HERE, "reference")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & (BANNED | {"hacktv_tpu_torch"}), path


def test_harness_imports_no_jax():
    for path in _py_files(HERE):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & BANNED, path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hacktv_tpu_torch_like", object())
    assert "hacktv_tpu_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
