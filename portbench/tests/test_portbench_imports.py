"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "neural_renderer_v2_pytorch_tpu"}
PORT = "neural_renderer_v2_pytorch_tpu_torch"
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    """Top-level names of every module ``path`` imports, and the dotted
    names of its relative imports resolved inside the benchmark."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in imported(path)
    tree = ast.parse(path.read_text())
    relative = [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level]
    assert not relative, "the reference imports no other module of the benchmark either"


def test_the_guard_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom neural_renderer_v2_pytorch_tpu import ops\n"
                 f"import {PORT}\n")
    assert imported(p) & FORBIDDEN == {"jax", "neural_renderer_v2_pytorch_tpu"}
