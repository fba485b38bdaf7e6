"""No module the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
import os
import sys

from conftest import ROOT

BENCH_DIR = os.path.join(ROOT, "benchmark")


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_nor_the_jax_package():
    for path in sources():
        if os.sep + "tests" + os.sep in path:
            continue
        bad = set(imported(path)) & {"jax", "jaxlib", "flax", "pcgmix_tpu"}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        assert "pcgmix_tpu_torch" not in set(imported(path)), path
        assert "pcgmix_tpu" not in set(imported(path)), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "pcgmix_tpu_torch_lookalike", object())
    assert "pcgmix_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pcgmix_tpu.rng", object())
    assert harness.forbidden_modules() == ["pcgmix_tpu"]
