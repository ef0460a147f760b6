"""Nothing the benchmark runs loads JAX or the JAX package, and the
plain reference loads nothing of the program.  Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys
import types

import pytest

from bench_helpers import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "strawboat_tpu"}


def _sources(sub=""):
    for d, _dirs, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_top_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    tops = set(_top_imports(path))
    assert "strawboat_tpu_torch" not in tops and not tops & FORBIDDEN
    assert tops <= {"__future__", "typing", "numpy", "benchmark", "dataclasses", "math", "os",
                    "concurrent"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "strawboat_tpu_torchx", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "strawboat_tpu.exec", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax", "strawboat_tpu"]


_PROBE = """
import io, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from bench_helpers import tiny_run
from benchmark import run
for cell in ("resident_q1", "resident_q6", "file_ingest_1m"):
    assert tiny_run(cell, trace=1, seconds=0.2)["correct"], cell
print(sorted({{m.split(".")[0] for m in sys.modules}} & {forbidden!r}))
"""


def test_a_run_of_every_cell_loads_no_forbidden_module():
    code = _PROBE.format(root=ROOT, tests=os.path.dirname(__file__), forbidden=FORBIDDEN)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
