"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Top-level module names are compared
whole: ``vltk_tpu_torch`` is not ``vltk_tpu``."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "vltk_tpu"}


def _sources(sub: str = ""):
    root = os.path.join(harness.BENCH_DIR, sub)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, harness.BENCH_DIR))
def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"vltk_tpu_torch"})


def test_the_check_compares_whole_top_level_names():
    sys.modules.setdefault("vltk_tpu_torch_lookalike", sys)
    try:
        assert "vltk_tpu_torch_lookalike" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("vltk_tpu_torch_lookalike", None)


def test_a_run_leaves_no_jax_module_loaded():
    code = ("import sys; from benchmark.tests import tiny; from benchmark import harness; "
            "tiny.run('docs.layoutlm.infer.b32', seconds=0.5); print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
