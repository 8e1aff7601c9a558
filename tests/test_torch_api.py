"""The port's public API against the JAX package's, and its independence
from JAX: every name the JAX package's ``__init__`` imports is exported by
the port, with the same ``__version__``; no module of the port and nothing
in ``chip_smoke.py`` imports ``jax`` or the JAX package, and no module of
``benchmarks/`` imports ``chip_smoke`` (read with ``ast``, so a
function-level import counts too)."""

import ast
import pathlib

import pytest

import neural_renderer_v2_pytorch_tpu as jnr
import neural_renderer_v2_pytorch_tpu_torch as tnr

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = "neural_renderer_v2_pytorch_tpu"
PORT = ROOT / "neural_renderer_v2_pytorch_tpu_torch"


def _jax_init_names():
    tree = ast.parse((ROOT / JAX_PKG / "__init__.py").read_text())
    return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names}


def test_port_exports_the_jax_api():
    names = _jax_init_names()
    assert len(names) >= 30
    assert names <= set(dir(tnr)), sorted(names - set(dir(tnr)))
    assert names <= set(dir(jnr))
    assert tnr.__version__ == jnr.__version__ == "2.0.2"
    assert set(tnr.__all__) <= set(dir(tnr))
    assert names <= set(tnr.__all__)


def _imported_modules(path):
    """Absolute module names ``path`` imports (relative imports resolved
    against its package)."""
    rel = path.relative_to(ROOT).with_suffix("")
    package = list(rel.parts[:-1] if rel.name != "__init__" else rel.parts[:-1])
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package[: len(package) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            out += [mod] + [f"{mod}.{a.name}" for a in node.names]
    return out


def _is_jax(name):
    return (name == "jax" or name.startswith(("jax.", "jaxlib", "optax", "flax"))
            or name == JAX_PKG or name.startswith(JAX_PKG + "."))


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if _is_jax(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", sorted((PORT / "benchmarks").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_benchmarks_import_no_chip_smoke(path):
    """The measurement modules stand alone: ``chip_smoke.py`` imports them,
    never the other way."""
    bad = [m for m in _imported_modules(path) if m.split(".")[0] == "chip_smoke"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_imports():
    """The scan itself: absolute, relative and function-level imports."""
    src = ROOT / "tests" / "test_torch_api.py"
    mods = _imported_modules(src)
    assert "neural_renderer_v2_pytorch_tpu" in mods and _is_jax("neural_renderer_v2_pytorch_tpu")
    assert not _is_jax("neural_renderer_v2_pytorch_tpu_torch.ops")
    assert "neural_renderer_v2_pytorch_tpu_torch.models.mesh" in _imported_modules(
        PORT / "__init__.py")
