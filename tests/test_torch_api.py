"""The port's public API against the JAX package's, and its independence
from JAX: every name the JAX package's ``__init__`` imports is exported by
the port, with the same ``__version__``, and takes the JAX package's
arguments (every parameter name of each public class, function and method),
less the documented exceptions of :data:`NOT_TAKEN`; ``replace`` on the
parameter and light classes works as ``flax.struct``'s; no module of the
port and nothing in ``chip_smoke.py`` imports ``jax`` or the JAX package,
and no module of ``benchmarks/`` imports ``chip_smoke`` (read with
``ast``, so a function-level import counts too)."""

import ast
import dataclasses
import inspect
import pathlib

import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu as jnr
import neural_renderer_v2_pytorch_tpu_torch as tnr
from neural_renderer_v2_pytorch_tpu.ops import rasterize as jras
from neural_renderer_v2_pytorch_tpu_torch.utils.convert import lights_from_jax, params_from_jax

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


# the JAX arguments the port does not take: the TPU knobs of the parity map
# (README's port section) and optax's per-leaf rates, which the port's Adam
# takes as torch.optim parameter groups
NOT_TAKEN = {
    "RasterizeHyperparam": {"backend", "face_chunk", "batch_chunk", "planar_hot_path"},
    "RasterizeParam": {"slot_occupancy"},
    "compute_face_index_map": {"face_chunk"},
    "Adam": {"param_lrs"},
    "adam": {"param_lrs"},
}


def _parameters(fn):
    """The names a caller may pass to ``fn``; "*" and "**" for its variadic
    parameters, whose names a caller never writes."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):        # no signature to read
        return None
    variadic = {inspect.Parameter.VAR_POSITIONAL: "*", inspect.Parameter.VAR_KEYWORD: "**"}
    return {variadic.get(p.kind, p.name) for p in params}


def _public_callables(obj):
    """(label, callable): ``obj`` itself, then a class's public methods."""
    yield "", obj
    if inspect.isclass(obj):
        for name, member in inspect.getmembers(obj):
            if not name.startswith("_") and callable(member):
                yield name, member


@pytest.mark.parametrize("name", sorted(n for n in _jax_init_names() if callable(getattr(jnr, n))))
def test_port_takes_the_jax_arguments(name):
    """Each parameter name of the JAX callable, and of each public method of
    a JAX class, exists on the port's counterpart; what does not is exactly
    :data:`NOT_TAKEN`'s entry."""
    port = getattr(tnr, name)
    missing = {}
    for label, fn in _public_callables(getattr(jnr, name)):
        counterpart = getattr(port, label) if label else port
        want, got = _parameters(fn), _parameters(counterpart)
        assert (want is None) == (got is None), (name, label)
        if want and want - got:
            missing[label or name] = want - got
    assert missing == ({name: NOT_TAKEN[name]} if name in NOT_TAKEN else {})


@pytest.mark.parametrize("call", [
    lambda knob: tnr.RasterizeHyperparam(**{knob: None}),
    lambda knob: tnr.RasterizeHyperparam().replace(**{knob: None}),
], ids=["init", "replace"])
@pytest.mark.parametrize("knob", sorted(NOT_TAKEN["RasterizeHyperparam"]))
def test_tpu_knobs_raise(call, knob):
    with pytest.raises(TypeError, match=knob):
        call(knob)


def test_tpu_parameters_raise():
    with pytest.raises(TypeError, match="slot_occupancy"):
        tnr.RasterizeParam(slot_occupancy=None)
    with pytest.raises(TypeError, match="face_chunk"):
        tnr.compute_face_index_map(torch.zeros((1, 1, 3, 3)), 8, face_chunk=16)
    with pytest.raises(TypeError, match="param_lrs"):
        tnr.Adam([torch.zeros(1, requires_grad=True)], param_lrs=None)


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.rand(*shape).astype(np.float32) for k, shape in (
        ("color", (1, 3)), ("direction", (1, 3)), ("alpha", (1,)), ("textures", (1, 3, 4, 4)))}


# class -> (fields it is built with, the field replaced)
REPLACED = {
    "RasterizeParam": (("textures",), "textures"),
    "AmbientLight": (("color",), "color"),
    "DirectionalLight": (("color", "direction"), "direction"),
    "SpecularLight": (("color", "alpha"), "alpha"),
}


def _as_numpy(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("name", sorted(REPLACED))
def test_replace_copies_as_the_jax_class_does(name):
    """``replace`` returns a new object with the field replaced and the
    rest kept, leaves the old one as it was, and raises ``TypeError`` on a
    field the class lacks, as the JAX class's does; ``convert`` carries a
    JAX object built through ``replace`` across."""
    fields, field = REPLACED[name]
    old, new = _arrays(0), _arrays(1)
    jcls = getattr(jras, name) if name == "RasterizeParam" else getattr(jnr, name)
    jax_obj = jcls(**{k: old[k] for k in fields}).replace(**{field: new[field]})
    port = getattr(tnr, name)(**{k: torch.tensor(old[k]) for k in fields})
    replaced = port.replace(**{field: torch.tensor(new[field])})
    assert type(replaced) is type(port) and replaced is not port
    np.testing.assert_array_equal(getattr(port, field).numpy(), old[field])
    for k in fields:
        np.testing.assert_array_equal(getattr(replaced, k).numpy(), (new if k == field else old)[k])
        np.testing.assert_array_equal(getattr(replaced, k).numpy(), _as_numpy(getattr(jax_obj, k)))
    if name == "RasterizeParam":
        carried = params_from_jax(jax_obj, "cpu")
    else:
        (carried,) = lights_from_jax([jax_obj], "cpu")
    for f in dataclasses.fields(replaced):
        got, want = getattr(carried, f.name), getattr(replaced, f.name)
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want), f.name
        else:
            assert got == want, f.name
    for obj in (port, jax_obj):
        with pytest.raises(TypeError):
            obj.replace(bogus=1)


def test_params_from_jax_takes_the_object_or_its_fields():
    jp = jras.RasterizeParam(textures=_arrays(0)["textures"], texture_size=4,
                             background_color=(0.1, 0.2, 0.3))
    fields = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    a, b = params_from_jax(jp, "cpu"), params_from_jax(fields, "cpu")
    assert torch.equal(a.textures, b.textures) and a.texture_size == b.texture_size == 4
    assert a.background_color == b.background_color == (0.1, 0.2, 0.3)


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
