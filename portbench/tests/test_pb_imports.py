"""Nothing under portbench/ imports JAX or the JAX package (top-level
module names compared whole), and the reference imports nothing of the
program."""

import ast
from pathlib import Path

import pytest

from portbench import bench

FILES = sorted(bench.PORTBENCH.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(bench.PORTBENCH)))
def test_no_jax(path):
    tops = set(_imports(path))
    assert not tops & {"jax", "jaxlib", "flax", "qaray_tpu"}, tops
    if "reference" in path.relative_to(bench.PORTBENCH).parts:
        assert "qaray_tpu_torch" not in tops
        assert "portbench" not in tops  # relative imports only


def test_forbidden_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "qaray_tpu_torch_x", types.ModuleType(
        "qaray_tpu_torch_x"))
    assert "qaray_tpu_torch_x" not in bench.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "qaray_tpu.cli", types.ModuleType("x"))
    assert bench.forbidden_loaded() == ["qaray_tpu.cli"]
