"""Nothing of the benchmark imports JAX, the JAX package or its benchmark
script, compared by whole top-level module names (the program's package
begins with the JAX package's name and is not it); the plain reference
imports nothing of the program; a fresh process that runs a cell at a tiny
size on the CPU ends with none of them loaded."""

import ast
import os
import subprocess
import sys

from iblb_benchmark import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "cuda_iblb_11_tpu", "bench"}


def _sources(sub=""):
    base = os.path.join(HERE, sub)
    for root, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _tops(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    found = [(os.path.relpath(p, HERE), t) for p in _sources()
             for t in _tops(p) if t in BANNED]
    assert not found
    assert len(list(_sources())) > 20


def test_reference_imports_nothing_of_the_program():
    found = [(os.path.relpath(p, HERE), t)
             for p in _sources("reference") for t in _tops(p)
             if t not in ("__future__", "numpy", "torch", "dataclasses",
                          "iblb_benchmark")]
    assert not found
    # and within the benchmark only the reference itself
    for p in _sources("reference"):
        with open(p) as fh:
            tree = ast.parse(fh.read(), p)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.startswith("iblb_benchmark"):
                assert node.module.startswith("iblb_benchmark.reference")


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cuda_iblb_11_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    monkeypatch.setitem(sys.modules, "benchmarks", sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "cuda_iblb_11_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.banned_modules() == ["cuda_iblb_11_tpu", "jax"]


_CHILD = r"""
import json, sys
from iblb_benchmark import harness
from iblb_benchmark.tests import rehearse
with open("BENCHMARK.json") as fh:
    name = json.load(fh)["workloads"][0]["name"]
r = rehearse.run(harness.load_cell(name), 5)
assert r["correct"], r["checks"]
print("BANNED", harness.banned_modules())
"""


def test_a_run_loads_none_of_them():
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BANNED []" in out.stdout
