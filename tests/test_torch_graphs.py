"""The compiled core (``ops/graphs.py``, ``ops/rasterize.py::_run``) on the
CPU: what keys a render's graph, when a render is captured and when it runs
eagerly, how a binned render sizes K7's capped bins and when a graph whose
replay overflowed is captured anew, and that the step a graph would hold
makes no host sync and copies nothing from the host once its per-faces
constants are built (on either resolve route).  The CPU
never captures: there the entry points give ``rasterize_core``'s bits,
which are the JAX package's (checked here against its eager pipeline).
The card-side checks (capture, replay, fresh outputs, recapture) are in
``tests/test_torch_cuda.py``."""

import collections
import ctypes
import dataclasses
import gc
import inspect
import logging
import types
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import neural_renderer_v2_pytorch_tpu as jnr
import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu_torch.ops import (
    camera,
    gather_resolve,
    graphs,
    rasterize,
    shading,
)
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops.rasterize import RasterizeHyperparam as HP
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import (
    atlas_scene,
    lit_light_arrays,
    texel_scene,
    torus,
)

LIGHTS = {"ambient": nr.AmbientLight, "directional": nr.DirectionalLight,
          "specular": nr.SpecularLight}


def _lights(grad=True):
    out = []
    for kind, arrays in lit_light_arrays():
        fields = {k: torch.tensor(a) for k, a in arrays.items()}
        fields["color"].requires_grad_(grad)
        out.append(LIGHTS[kind](**fields))
    return tuple(out)


def _scene(kind):
    """(renderer, vertices, faces, vt, ft, textures, lights) at 32^2 AA."""
    if kind == "atlas":
        v, f, vt, ft, tex = atlas_scene(12, 8, 40, 64)
        ts, lights = None, None
    else:
        v, f, vt, ft, tex = texel_scene(12, 8, 2)
        ts, lights = 2, (_lights() if kind == "lit" else None)
    r = nr.Renderer("cpu")
    r.image_size, r.texture_size = 32, ts
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
    return (r, torch.tensor(v[None]), f, torch.tensor(vt), ft,
            torch.tensor(tex, requires_grad=kind == "atlas"), lights)


def _signature(v, params=None, hp=HP(image_size=32)):
    return rasterize.graph_signature(v, params or nr.RasterizeParam(), hp)[0]


# ---------------------------------------------------------------------------
# the key


def _textured_params(**kw):
    v, f, vt, ft, tex = texel_scene(6, 4, 2)
    base = dict(vertices_textures=torch.tensor(vt), faces_textures=torch.tensor(ft),
                textures=torch.tensor(tex), texture_size=2)
    base.update(kw)
    return torch.tensor(v[None]), nr.RasterizeParam(**base)


def test_signature_is_the_same_for_the_same_call():
    v, p = _textured_params(lights=_lights(), background_color=(0.2, 0.4, 0.6))
    assert _signature(v, p) == _signature(v.clone(), p)
    # fresh tensors of the same structure (texel faces too: an input of the
    # graph, copied in at each call), fresh lights: the same graph
    _, q = _textured_params(lights=_lights(), background_color=[0.2, 0.4, 0.6],
                            faces_textures=p.faces_textures.clone())
    assert _signature(v, p) == _signature(v, q)
    assert hash(_signature(v, p)) == hash(_signature(v, q))


def _replace(p, **kw):
    return dataclasses.replace(p, **kw)


CHANGES = {
    "shape": lambda v, p: (v[:, :-1].contiguous(), p),
    "batch": lambda v, p: (v.expand(2, -1, -1).contiguous(), p),
    "strides": lambda v, p: (v.transpose(1, 2).contiguous().transpose(1, 2), p),
    "dtype": lambda v, p: (v.double(), p),
    "requires_grad": lambda v, p: (v.clone().requires_grad_(True), p),
    "texture requires_grad": lambda v, p: (
        v, _replace(p, textures=p.textures.clone().requires_grad_(True))),
    "background_color": lambda v, p: (v, _replace(p, background_color=(0.2, 0.4, 0.7))),
    "backgrounds": lambda v, p: (v, _replace(p, backgrounds=torch.zeros(1, 3, 64, 64))),
    "texture_size": lambda v, p: (v, _replace(p, texture_size=None)),
    "no lights": lambda v, p: (v, _replace(p, lights=None)),
    "empty lights": lambda v, p: (v, _replace(p, lights=())),
    "light backside": lambda v, p: (v, _replace(p, lights=(
        nr.DirectionalLight(p.lights[0].color, p.lights[0].direction, True),
        *p.lights[1:]))),
    "specular alpha": lambda v, p: (v, _replace(p, lights=(
        *p.lights[:2], nr.SpecularLight(p.lights[2].color, torch.ones(1))))),
    "faces_textures tensor": lambda v, p: (
        v, _replace(p, faces_textures=p.faces_textures.long())),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_signature_is_new_for_a_new_input_signature(change):
    v, p = _textured_params(lights=_lights(), background_color=(0.2, 0.4, 0.6))
    assert _signature(*CHANGES[change](v, p)) != _signature(v, p)


@pytest.mark.parametrize("field", ["image_size", "anti_aliasing", "near", "draw_backside",
                                   "draw_depth"])
def test_signature_is_new_for_new_hyperparameters(field):
    v, p = _textured_params()
    hp = HP(image_size=32)
    other = hp.replace(**{field: {"image_size": 48, "near": 0.2}.get(
        field, not getattr(hp, field))})
    assert _signature(v, p, hp) != _signature(v, p, other)


def test_signature_follows_the_grad_mode_and_in_place_edits_of_faces_textures():
    v, p = _textured_params()
    key = _signature(v, p)
    with torch.no_grad():
        no_grad = _signature(v, p)
        assert no_grad != key
    with torch.inference_mode():
        assert _signature(v, p) not in (key, no_grad)
    # texel faces are copied into the graph at each call: an edit needs no
    # new graph
    p.faces_textures[0, 0] = 1
    assert _signature(v, p) == key


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty cache of records and graphs for the test."""
    monkeypatch.setattr(graphs, "_records", {})
    monkeypatch.setattr(graphs, "_entries", collections.OrderedDict())


def test_faces_record_is_kept_per_faces_tensor_and_leaves_with_it(fresh_cache):
    f = torch.tensor(torus(8, 6)[1])
    record = graphs.faces_record(f)
    assert graphs.faces_record(f) is record
    assert record.faces.dtype == torch.int32 and torch.equal(record.faces, f)
    assert record.faces is not f                           # its own copy
    assert graphs.faces_record(f.clone()) is not record    # another live tensor
    f64 = f.long()
    assert graphs.faces_record(f64).faces.dtype == torch.int32
    assert graphs.faces_record(f64) is graphs.faces_record(f64)   # one conversion
    f[0] = f[1]                                            # an in-place edit
    edited = graphs.faces_record(f)
    assert edited is not record and torch.equal(edited.faces[0], f[1])
    assert graphs.faces_record(f) is edited
    key = id(f)
    del f, edited
    gc.collect()
    assert key not in graphs._records


def test_a_fresh_faces_tensor_at_each_call_captures_nothing(fresh_cache, caplog):
    """``faces.int()`` in the loop: each call is a signature's first call
    over its faces tensor, which runs eagerly (logged once), so nothing is
    captured and nothing is kept past the tensor."""
    f = torch.tensor(torus(8, 6)[1]).long()
    made = []
    graphs.note_eager.cache_clear()
    with caplog.at_level(logging.INFO, logger=graphs.__name__):
        for _ in range(4):
            faces = f.int()                            # the last step's tensor dies
            record = graphs.faces_record(faces)
            assert graphs.cached_graph(record, ("a",), _fake_capture(made), "fresh") is None
            assert len(graphs._entries) == 1
    del faces
    assert made == [] and graphs._records == {} and len(graphs._entries) == 0
    assert sum("first call of a signature" in r.getMessage() for r in caplog.records) == 1


class _FakeGraph:
    """A graph's bookkeeping of its pending backward and of its replays'
    overflow bins, without a capture."""

    _waiting = None
    waiting = graphs.Graph.waiting
    pending = graphs.Graph.pending

    def __init__(self, min_capacity=0):
        self.min_capacity = min_capacity
        self.capacities = [max(graphs.CAPACITY_FLOOR, min_capacity)]
        self.overflow = 0

    def overflowed(self):
        return self.overflow


def _fake_capture(made):
    def capture(min_capacity=0):
        made.append(_FakeGraph(min_capacity))
        return made[-1]
    return capture


def test_cached_graph_captures_at_a_signatures_second_call(fresh_cache, caplog):
    """The first call runs eagerly (and says so), the second captures, the
    later ones replay that graph."""
    record = graphs.faces_record(torch.tensor(torus(8, 6)[1]))
    made = []
    graphs.note_eager.cache_clear()
    with caplog.at_level(logging.INFO, logger=graphs.__name__):
        assert graphs.cached_graph(record, ("a",), _fake_capture(made), "a label") is None
    assert any("first call of a signature" in r.getMessage() and "a label" in r.getMessage()
               for r in caplog.records)
    a = graphs.cached_graph(record, ("a",), _fake_capture(made))
    assert made == [a]
    assert graphs.cached_graph(record, ("a",), _fake_capture(made)) is a and len(made) == 1
    assert graphs.cached_graph(record, ("b",), _fake_capture(made)) is None
    assert graphs.graph_count() == 1 and len(graphs._entries) == 2


def test_cached_graph_captures_another_graph_while_one_waits_on_a_backward(fresh_cache,
                                                                          caplog):
    """Renders of one signature whose backwards are pending at once (views
    summed into one loss) replay graphs of their own, up to MAX_INSTANCES;
    past that they run eagerly; a graph is free again once its backward ran
    or its render was dropped."""
    record = graphs.faces_record(torch.tensor(torus(8, 6)[1]))
    made, tokens = [], []
    capture = _fake_capture(made)
    graphs.cached_graph(record, ("a",), capture)
    for _ in range(graphs.MAX_INSTANCES):
        g = graphs.cached_graph(record, ("a",), capture)
        tokens.append(graphs._Pending())
        g.waiting = tokens[-1]                 # its backward is pending
    assert len(set(map(id, made))) == graphs.MAX_INSTANCES == graphs.graph_count()
    graphs.note_eager.cache_clear()
    with caplog.at_level(logging.INFO, logger=graphs.__name__):
        assert graphs.cached_graph(record, ("a",), capture, "four views") is None
    assert any("wait on their backward" in r.getMessage() for r in caplog.records)
    made[2].waiting = None                     # its backward ran
    assert graphs.cached_graph(record, ("a",), capture) is made[2]
    del tokens[0]                              # its render was dropped
    gc.collect()
    assert graphs.cached_graph(record, ("a",), capture) is made[0]
    assert len(made) == graphs.MAX_INSTANCES


def test_cached_graph_recaptures_a_graph_whose_replay_overflowed(fresh_cache, caplog):
    """A kept graph whose finished replay had overflow bins is replaced in
    its place by a capture at twice its capacity, counted and logged; a
    graph whose replay fitted, or is still running (0 read), is replayed."""
    record = graphs.faces_record(torch.tensor(torus(8, 6)[1]))
    made = []
    capture = _fake_capture(made)
    rc.reset_launches()
    graphs.cached_graph(record, ("a",), capture)
    first = graphs.cached_graph(record, ("a",), capture)
    assert graphs.cached_graph(record, ("a",), capture) is first
    first.overflow = 7
    with caplog.at_level(logging.INFO, logger=graphs.__name__):
        second = graphs.cached_graph(record, ("a",), capture, "overflowing")
    assert second is made[1] and second is not first
    assert second.min_capacity == 2 * first.capacities[0]
    assert graphs._entries[(record, ("a",))] == [second]
    assert rc.GRAPHS["overflow_recaptures"] == 1 and rc.GRAPHS["captures"] == 0
    assert any("7 overflow bins" in r.getMessage() and "overflowing" in r.getMessage()
               for r in caplog.records)
    assert graphs.cached_graph(record, ("a",), capture) is second
    # a pending graph is passed over, overflowed or not
    token = graphs._Pending()
    second.waiting, second.overflow = token, 3
    third = graphs.cached_graph(record, ("a",), capture)
    assert third is made[2] and third.min_capacity == 0 and second.pending()
    assert rc.GRAPHS["overflow_recaptures"] == 1


@pytest.mark.parametrize("total,want", [(0, 4096), (1, 4096), (2048, 4096), (2049, 8192),
                                        (100_000, 262_144), (131_072, 262_144)])
def test_bin_capacity_is_twice_the_total_to_a_power_of_two(total, want):
    assert graphs.bin_capacity(total) == want
    with graphs.forced_capacity(5):
        assert graphs.bin_capacity(total) == 5
    assert graphs.bin_capacity(total) == want


def test_cached_graph_keeps_at_most_max_entries(fresh_cache):
    """Signatures over any faces, least recently used out first: the
    graphs kept stay within the caps whatever a fit sends."""
    faces = [torch.tensor(torus(8, 6)[1]) + k for k in range(3)]
    records = [graphs.faces_record(f) for f in faces]
    made = []
    capture = _fake_capture(made)
    for n in range(3 * graphs.MAX_ENTRIES):
        for _ in range(2):
            graphs.cached_graph(records[n % 3], ("bs", n), capture)
        assert len(graphs._entries) <= graphs.MAX_ENTRIES
        assert graphs.graph_count() <= graphs.MAX_ENTRIES
    assert len(made) == 3 * graphs.MAX_ENTRIES
    last = records[(3 * graphs.MAX_ENTRIES - 1) % 3], ("bs", 3 * graphs.MAX_ENTRIES - 1)
    assert graphs._entries[last] == [made[-1]]
    # the most recently used stays when a new one comes
    first_kept = next(iter(graphs._entries))
    graphs.cached_graph(*first_kept, capture)
    graphs.cached_graph(records[0], ("new",), capture)
    assert first_kept in graphs._entries


def test_graphs_leave_with_their_faces_tensor(fresh_cache):
    """A faces tensor's signatures go when it dies or is edited in place;
    another tensor's stay."""
    f, g = (torch.tensor(torus(8, 6)[1]) + k for k in range(2))
    made = []
    capture = _fake_capture(made)
    for faces in (f, g):
        for _ in range(2):
            graphs.cached_graph(graphs.faces_record(faces), ("a",), capture)
    assert graphs.kept_graphs(f) == [made[0]] and graphs.kept_graphs(g) == [made[1]]
    g[0, 0] = 5                                    # an in-place edit
    assert graphs.kept_graphs(g) == [] and graphs.graph_count() == 1
    for _ in range(2):
        graphs.cached_graph(graphs.faces_record(g), ("a",), capture)
    assert graphs.kept_graphs(g) == [made[2]]
    del g, faces
    gc.collect()
    assert graphs.graph_count() == 1 and graphs.kept_graphs(f) == [made[0]]
    assert len(graphs._entries) == 1


# ---------------------------------------------------------------------------
# eager() and the route of a render


def test_eager_nests_and_restores():
    assert not graphs._state["eager"]
    with nr.eager():
        assert graphs._state["eager"]
        with nr.eager():
            assert graphs._state["eager"]
        assert graphs._state["eager"]
    assert not graphs._state["eager"]
    with pytest.raises(KeyError):
        with nr.eager():
            raise KeyError
    assert not graphs._state["eager"]


def _on_card(bs, nv=3):
    """A stand-in for card vertices: the route reads the device and shapes
    only."""
    return types.SimpleNamespace(is_cuda=True, shape=(bs, nv, 3))


@pytest.fixture
def not_capturing(monkeypatch):
    monkeypatch.setattr(graphs, "capturing", lambda: False)


def test_route_of_a_render(monkeypatch, not_capturing, caplog):
    faces = torch.zeros((2560, 3), dtype=torch.int32)
    hp = HP(image_size=256)
    assert graphs.route(torch.zeros(1, 3, 3), faces, hp) == "eager"      # the CPU
    assert graphs.route(_on_card(1), faces, hp) == "graph"
    with nr.eager():
        assert graphs.route(_on_card(1), faces, hp) == "eager"
    with rc.plain_versions():
        assert graphs.route(_on_card(1), faces, hp) == "eager"
    graphs.note_eager.cache_clear()          # each reason is logged once
    with rc.forced_route("binned"):
        with caplog.at_level(logging.INFO, logger=graphs.__name__):
            assert graphs.route(_on_card(1), faces, hp) == "graph"
    assert not any("eager" in r.getMessage() for r in caplog.records)
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    assert graphs.route(_on_card(1), faces, hp) == "inline"
    with rc.forced_route("binned"):
        assert graphs.route(_on_card(1), faces, hp) == "inline"


@pytest.mark.parametrize("binned_from", [rc.BINNED_FROM, 10_000, 2_000_000])
def test_graphs_follow_resolve_route_and_binned_from(monkeypatch, not_capturing, binned_from,
                                                     caplog):
    """Graphed on both sides of the threshold ``BINNED_FROM``, where
    ``resolve_route`` picks the tiled or the binned route from the shapes,
    and nothing logs a render as eager for its route."""
    monkeypatch.setattr(rc, "BINNED_FROM", binned_from)
    graphs.note_eager.cache_clear()
    routes = set()
    with caplog.at_level(logging.INFO, logger=graphs.__name__):
        for image_size, aa in ((64, True), (256, True), (512, False), (1024, True)):
            hp = HP(image_size=image_size, anti_aliasing=aa)
            S = image_size * (2 if aa else 1)
            tiles = (-(-S // 16)) ** 2
            for bs in (1, 3):
                for nf in (1, binned_from // (bs * tiles), -(-binned_from // (bs * tiles)),
                           2560, 81920):
                    tiled = rc.resolve_route(bs, S, S, nf) == "tiled"
                    assert tiled == (bs * tiles * nf < binned_from)
                    routes.add(tiled)
                    faces = torch.zeros((nf, 3), dtype=torch.int32)
                    assert graphs.route(_on_card(bs), faces, hp) == "graph"
    assert routes == {True, False}
    assert not caplog.records


# ---------------------------------------------------------------------------
# the CPU: nothing captured, rasterize_core's bits


@pytest.mark.parametrize("entry", ["silhouettes", "rgba", "rgb", "depth", "all"])
def test_cpu_captures_nothing_and_gives_rasterize_core_bits(entry):
    r, v, f, vt, ft, tex, lights = _scene("lit")
    ndc = r.transform_vertices(v).detach()
    params = nr.RasterizeParam(vertices_textures=vt, faces_textures=torch.tensor(ft),
                               textures=tex.detach(), texture_size=2, lights=lights,
                               background_color=(0.25, 0.5, 0.75))
    hp = HP(image_size=32)
    fn = getattr(nr, f"rasterize_{entry}")
    rc.reset_launches()
    before = graphs.graph_count()
    x = ndc.clone().requires_grad_(True)
    got = fn(x, torch.tensor(f).long(), params, hp)
    (got * got).sum().backward()
    assert graphs.graph_count() == before == 0 and rc.GRAPHS["captures"] == 0
    assert rc.GRAPHS["forward_replays"] == 0 and rc.GRAPHS["backward_replays"] == 0
    flags = {"silhouettes": (False, True, False), "rgba": (True, True, False),
             "rgb": (True, False, False), "depth": (False, False, True),
             "all": (True, True, True)}[entry]
    y = ndc.clone().requires_grad_(True)
    want = rasterize.rasterize_core(
        y, torch.tensor(f), params,
        hp.replace(draw_rgb=flags[0], draw_silhouettes=flags[1], draw_depth=flags[2]))
    if entry in ("silhouettes", "depth"):
        want = want[:, 0]
    (want * want).sum().backward()
    assert torch.equal(got, want) and torch.equal(x.grad, y.grad)


def test_cpu_silhouettes_match_the_jax_package_through_the_entry_point():
    """The entry point that a card would replay gives the JAX package's
    image bits and its gradient within the goldens' bound (eager JAX)."""
    v, f = torus(12, 8)
    r = nr.Renderer("cpu")
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 20)
    ndc = r.transform_vertices(torch.tensor(v[None])).detach().numpy()
    x = torch.tensor(ndc, requires_grad=True)
    images = nr.rasterize_silhouettes(x, torch.tensor(f).long(), None, HP(image_size=32))
    (images * images).sum().backward()
    hp = jnr.RasterizeHyperparam(image_size=32)
    with jax.disable_jit():
        jimages = np.asarray(jnr.rasterize_silhouettes(jnp.asarray(ndc), f, None, hp))
        jgrad = np.asarray(jax.grad(lambda a: jnp.sum(
            jnr.rasterize_silhouettes(a, f, None, hp) ** 2))(jnp.asarray(ndc)))
    np.testing.assert_array_equal(images.detach().numpy(), jimages)
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# what a graph would hold: no host sync, nothing copied from the host

# ops that read a device value back to the host or size their output by it
SYNCING = {"aten::_local_scalar_dense", "aten::bincount", "aten::nonzero",
           "aten::masked_select", "aten::_unique2", "aten::unique_dim",
           "aten::unique_consecutive", "aten::repeat_interleave.Tensor"}
# tensors made from host data: torch.tensor / as_tensor of Python values
FROM_HOST_OPS = {"aten::lift_fresh", "aten::lift_fresh_copy"}
FROM_HOST_FUNCTIONS = {torch.tensor, torch.as_tensor, torch.from_numpy, torch.asarray}
MOVING = {torch.Tensor.to, torch.Tensor.cuda, torch.Tensor.cpu, torch.Tensor.copy_}


class _Watch(TorchDispatchMode):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _paused[0]:
            packet = func.overloadpacket._qualified_op_name
            for n in (packet, f"{packet}.{func._overloadname}"):
                if n in SYNCING or n in FROM_HOST_OPS:
                    self.seen.append(n)
            if packet == "aten::segment_reduce" and not (kwargs.get("unsafe") or (
                    len(args) > 6 and args[6])):
                # without unsafe it checks the lengths on the host
                self.seen.append("aten::segment_reduce (lengths checked on the host)")
        return func(*args, **kwargs)


class _WatchCalls(TorchFunctionMode):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _paused[0]:
            if func in FROM_HOST_FUNCTIONS:
                self.seen.append(f"{func.__name__} (host data)")
            elif func in MOVING and (len(args) > 1 or "device" in kwargs or
                                     func in (torch.Tensor.cuda, torch.Tensor.cpu)):
                # .to(dtype) stays on the device; a device argument (or a
                # copy_ between tensors) may move host data
                moving = func is not torch.Tensor.to or "device" in kwargs or any(
                    isinstance(a, (str, torch.device)) or (
                        isinstance(a, torch.Tensor) and a.device != args[0].device)
                    for a in args[1:])
                if moving and func is torch.Tensor.copy_:
                    moving = args[1].device != args[0].device
                if moving:
                    self.seen.append(f"{func.__name__} (a move)")
        return func(*args, **kwargs)


_paused = [0]


def _unwatched(fn):
    def call(*args, **kwargs):
        _paused[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _paused[0] -= 1
    return call


@pytest.fixture
def plain_unwatched(monkeypatch):
    """The kernels' plain versions run unwatched: the card never runs them
    (their binning and masks size outputs on the host).  The wrappers
    around them, and the choice of K7's form, are watched."""
    for name in dir(rc):
        if name.endswith("_plain"):
            monkeypatch.setattr(rc, name, _unwatched(getattr(rc, name)))
    # K4's table (built once per faces tensor, before a capture)
    monkeypatch.setattr(shading, "vertex_slots", _unwatched(rc.vertex_slots))


def _steps():
    """name -> a function that makes its scene and returns a full step
    (camera, render, loss, backward) on the CPU over it."""
    def silhouettes(route="tiled"):
        def make():
            r, v, f = _scene("plain")[:3]

            def step():
                x = v.clone().requires_grad_(True)
                with rc.forced_route(route):
                    images = r.render_silhouettes(x, f)
                (torch.sum(images * images) / (torch.sum(images) + 1.0)).backward()
            return step
        return make

    def textured(kind, method="render", background=False):
        def make():
            r, v, f, vt, ft, tex, lights = _scene(kind)
            r.background_color = (0.25, 0.5, 0.75) if background else None

            def step():
                x = v.clone().requires_grad_(True)
                out = getattr(r, method)(x, f, vt, ft, tex, lights=lights)
                torch.sum(out * out).backward()
            return step
        return make

    def depth():
        r, v, f = _scene("plain")[:3]

        def step():
            x = v.clone().requires_grad_(True)
            torch.sum(r.render_depth(x, f)).backward()
        return step

    def everything():
        r, v, f, vt, ft, tex, lights = _scene("lit")
        params = nr.RasterizeParam(vertices_textures=vt, faces_textures=torch.tensor(ft),
                                   textures=tex, texture_size=2, lights=lights,
                                   backgrounds=torch.rand(1, 3, 64, 64, requires_grad=True))
        faces = torch.tensor(f)

        def step():
            x = v.clone().requires_grad_(True)
            out = nr.rasterize_all(r.transform_vertices(x), faces, params, HP(image_size=32))
            torch.sum(out * out).backward()
        return step

    return {"silhouettes": silhouettes(), "silhouettes binned": silhouettes("binned"),
            "atlas": textured("atlas"), "lit": textured("lit"),
            "texel rgb": textured("plain", "render_rgb", True), "depth": depth,
            "all with backgrounds": everything}


@pytest.mark.parametrize("name", sorted(_steps()))
def test_the_step_makes_no_host_sync_and_copies_nothing_from_the_host(name, plain_unwatched,
                                                                       monkeypatch):
    """The whole step (camera, render, loss, backward) as a caller's
    capture would hold it: its host numbers filled on the device."""
    step = _steps()[name]()
    step()                         # builds the per-faces constants, the grids
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    seen = []
    with _WatchCalls(seen), _Watch(seen):
        step()
    assert not seen, seen


def test_the_binned_step_under_capture_takes_the_capped_bins(monkeypatch):
    """A binned render as a caller's capture holds it (``capturing``
    patched true, after an eager warm-up of the same render) bins through
    K7's capped form at the kept total's capacity and gives the eager bits;
    at a forced capacity of 0 every bin overflows, to the same bits; a
    render with no eager run of its binning kept raises instead of reading
    back."""
    r, v, f = _scene("plain")[:3]
    faces = torch.tensor(f)
    calls = []
    bin_faces = rc.bin_faces
    monkeypatch.setattr(rc, "bin_faces", lambda *a, **kw: calls.append(kw.get("capacity"))
                        or bin_faces(*a, **kw))

    def render(faces=faces):
        with rc.forced_route("binned"):
            return r.render_silhouettes(v, faces)

    want = render()
    (total,) = graphs.faces_record(faces).bin_totals.values()
    assert calls == [None] and total > 0
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    assert torch.equal(render(), want)
    with graphs.forced_capacity(0):
        assert torch.equal(render(), want)
    with graphs.forced_capacity(total - 1):
        assert torch.equal(render(), want)
    assert calls == [None, graphs.bin_capacity(total), 0, total - 1]
    with pytest.raises(RuntimeError, match="run the step once before capturing"):
        render(faces.clone())
    with pytest.raises(RuntimeError, match="run the step once before capturing"):
        with rc.forced_route("binned"):
            r.render_silhouettes(v.expand(2, -1, -1), faces)          # another batch
    assert len(calls) == 4


def test_capped_k7_wrapper_reads_nothing_back(monkeypatch):
    """K7's wrapper on the card's path (the launches faked on CPU tensors):
    the eager form reads the pair total back once; the capped form reads
    nothing and returns its overflow word, a view of the kernel's scratch."""
    launched = []
    # 2 images of 8 x 3 tiles: the counters padded to one scan chunk, four
    # control words and one chunk's scan state
    scratch_words = rc.BIN_SCAN_TILE + 4 + 2

    def launch(entry, index, *args):
        if entry == "bin_faces_count":       # zeroes the scratch: a total of 0
            ctypes.memset(args[1], 0, 4 * scratch_words)
        launched.append((entry, args[-1]))

    monkeypatch.setattr(rc, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(rc, "_launch", launch)
    fvp = torch.zeros((2, 3, 3, 40))
    for capacity, syncs in ((None, 1), (4096, 0), (0, 0)):
        seen = []
        with _WatchCalls(seen), _Watch(seen):
            out = rc.bin_faces(fvp, True, 64, 8, 24, capacity=capacity)
        assert sum("_local_scalar_dense" in x for x in seen) == syncs, seen
        assert len(out) == (3 if capacity is None else 4)
        if capacity is not None:
            cnt, offsets, ids, overflow = out
            assert ids.shape == (capacity,) and overflow.shape == (1,)
            assert overflow.dtype == torch.int32
            assert launched[-1] == ("bin_faces", capacity)
        assert [e for e, _ in launched[-2:]] == ["bin_faces_count", "bin_faces"]


def test_the_watch_sees_what_it_looks_for(plain_unwatched):
    """The modes above see each kind of op they must refuse."""
    seen = []
    x = torch.arange(6.0)
    with _WatchCalls(seen), _Watch(seen):
        float(x.sum())
        torch.bincount(torch.tensor([1, 2]))
        torch.nonzero(x > 2)
        x.to("cpu")
        torch.segment_reduce(x, "sum", lengths=torch.full((2,), 3))
    assert any("_local_scalar_dense" in s for s in seen)
    assert any("bincount" in s for s in seen) and any("nonzero" in s for s in seen)
    assert any("host data" in s for s in seen) and any("a move" in s for s in seen)
    assert any("segment_reduce" in s for s in seen)


# ---------------------------------------------------------------------------
# the repairs: the same bits as before, without the host copy


@pytest.mark.parametrize("size", [64, 100, 200, 512, 1000])
def test_nmr_divisor_is_filled_with_torch_tensors_float32(size):
    assert torch.equal(torch.full((), 2.0 / size, dtype=torch.float32),
                       torch.tensor(2.0 / size, dtype=torch.float32))


def test_background_colour_and_camera_are_filled_with_as_tensors_bits():
    rng = np.random.RandomState(3)
    color = tuple(float(c) for c in rng.rand(3))
    got = rasterize.make_backgrounds(nr.RasterizeParam(background_color=color), 2, 8, "cpu")
    assert torch.equal(got[0, :, 0, 0], torch.as_tensor(color, dtype=torch.float32))
    assert got.shape == (2, 3, 8, 8)
    with pytest.raises(ValueError, match="3 values"):
        rasterize.make_backgrounds(nr.RasterizeParam(background_color=(1.0, 0.0)), 1, 4, "cpu")
    values = (tuple(rng.randn(3)), rng.randn(2, 3).astype(np.float32), 30.0, [0.1, 1, -2])
    for capturing in (False, True):
        with unittest.mock.patch.object(graphs, "capturing", lambda: capturing):
            got = rasterize.make_backgrounds(nr.RasterizeParam(background_color=color), 2, 8,
                                             "cpu")
            assert torch.equal(got[0, :, 0, 0], torch.as_tensor(color, dtype=torch.float32))
            for v in values:
                assert torch.equal(camera._on_device(v, torch.device("cpu")),
                                   torch.as_tensor(v, dtype=torch.float32))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket._qualified_op_name)
        return func(*args, **(kwargs or {}))


def test_constant_is_one_copy_outside_a_capture_and_fills_inside(monkeypatch):
    """Host numbers cost one copy whatever their count (the camera's
    tuples, the background colour), and one fill each only where a capture
    keeps them."""
    values = np.arange(12.0).reshape(4, 3) / 7
    for capturing, fills in ((False, 0), (True, values.size)):
        monkeypatch.setattr(graphs, "capturing", lambda: capturing)
        with _Ops() as mode:
            got = graphs.constant(values, torch.device("cpu"))
        assert torch.equal(got, torch.as_tensor(values, dtype=torch.float32))
        assert sum("fill" in op for op in mode.ops) == fills
        if not capturing:
            assert len(mode.ops) <= 2, mode.ops


def test_normals_from_the_kept_table_are_the_sorted_segment_sums_bits():
    v, f = torus(12, 8)
    x = torch.tensor(v[None] * np.float32(1.3))
    faces = torch.tensor(f)
    fv = gather_resolve.gather_face_vertices(x, faces)
    got = shading.face_vertex_normals(x, faces, fv)
    # the sort and count it replaced
    n = nr.cross(fv[:, :, 1] - fv[:, :, 0], fv[:, :, 2] - fv[:, :, 1], dim=1).permute(0, 2, 1)
    ids = faces.long().reshape(-1)
    vn = torch.segment_reduce(n.repeat_interleave(3, dim=1)[:, torch.argsort(ids, stable=True)],
                              "sum", lengths=torch.bincount(ids, minlength=len(v))[None],
                              axis=1)
    vn = vn / torch.clamp(torch.sqrt(torch.sum(vn * vn, dim=2, keepdim=True)), min=1e-12)
    assert torch.equal(got, vn[:, faces.long()])


def test_create_textures_defaults_to_the_card():
    from neural_renderer_v2_pytorch_tpu_torch.utils.helpers import create_textures

    assert inspect.signature(create_textures).parameters["device"].default == "cuda"
    vt, ft, tex = create_textures(3, 2, device="cpu")
    assert vt.device.type == ft.device.type == tex.device.type == "cpu"


def test_renderer_keeps_host_texel_faces():
    """Texel faces, like faces, passed as host ids every step give one
    tensor (one copy to the device); a tensor on the device passes as it
    is."""
    r, v, f, vt, ft, tex, _ = _scene("plain")
    kept = r._textured_params(vt, ft, tex, None, None).faces_textures
    assert r._textured_params(vt, ft.copy(), tex, None, None).faces_textures is kept
    t = torch.tensor(ft).long()
    assert r._textured_params(vt, t, tex, None, None).faces_textures is t
