"""No module of the benchmark imports JAX, Flax, Optax, Orbax or the JAX
package, compared by the whole top-level name (the port's name begins with
the JAX package's); nothing of the reference imports the port."""

from __future__ import annotations

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "guitar_tablature_classification_tpu"}
PORT = "guitar_tablature_classification_tpu_torch"


def _modules(under: str) -> list[str]:
    return sorted(os.path.join(base, f) for base, _, files in os.walk(under)
                  for f in files if f.endswith(".py"))


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", _modules(BENCH), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _modules(os.path.join(BENCH, "reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imports(path)
    with open(path) as f:
        assert PORT not in f.read()


def test_the_check_compares_whole_names():
    assert PORT.split(".")[0] not in FORBIDDEN
    from benchmark import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
