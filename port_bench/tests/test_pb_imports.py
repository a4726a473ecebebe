"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name,
up to its first dot, compared whole."""
import ast
import os

import pytest

from port_bench.harness.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "lie_vae_tpu"}


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax(path):
    assert not set(_top_names(path)) & FORBIDDEN


def test_names_compared_whole():
    # the port's name begins with the JAX package's; it is not that name
    assert "lie_vae_tpu_torch" not in FORBIDDEN
    assert "lie_vae_tpu_torch.models".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=os.path.basename)
def test_reference_stands_alone(path):
    assert set(_top_names(path)) <= {"contextlib", "math", "os", "numpy",
                                     "torch"}


def test_run_refuses_loaded_jax(monkeypatch):
    import sys
    import types
    from port_bench import run
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "lie_vae_tpu_torch_x",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax"]
