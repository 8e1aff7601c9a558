"""The compiled core's two later entries on the CPU: the sharded entry's
per-rank chain of graphs (``parallel/render.py``: what keys it, and
``ops/graphs.drive``, which cuts a rank's work at its collectives) and
``compute_face_index_map``'s graph (its key, its route, the capacity of
its binned form inside a capture), with the id/depth entry held to the
JAX package's jitted ``compute_face_index_map``.  The sharded segments
themselves run in the ranks of ``tests/test_torch_parallel.py``; the
captures and replays on the card are in ``tests/test_torch_cuda.py``."""

import contextlib
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu.ops import resolve as jres
from neural_renderer_v2_pytorch_tpu_torch.ops import gather_resolve, graphs
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.parallel import Mesh, collectives
from neural_renderer_v2_pytorch_tpu_torch.parallel import render as sharded
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import texel_scene

HP = nr.RasterizeHyperparam


# ---------------------------------------------------------------------------
# the sharded entry's key


class _Group:
    """A stand-in for a process group: the key holds groups by identity."""


def _mesh(shape=(1, 2, 1), coords=(0, 1, 0), groups=None):
    axes = ("data", "tile", "face")
    groups = groups or {k: _Group() for k in ("data", "tile", "face", "cells", "all")}
    return Mesh(dict(zip(axes, shape)), dict(zip(axes, coords)), groups)


def _inputs(grad=False):
    v, f, vt, ft, tex = texel_scene(6, 4, 2)
    params = nr.RasterizeParam(vertices_textures=torch.tensor(vt), faces_textures=torch.tensor(ft),
                               textures=torch.tensor(tex), texture_size=2)
    return torch.tensor(v[None], requires_grad=grad), params


def _key(vertices, params, hp=HP(image_size=32), mesh=None):
    return sharded.sharded_signature(vertices, params, hp, mesh or _MESH)[0]


_MESH = _mesh()


def test_sharded_signature_is_the_same_for_the_same_call():
    v, p = _inputs()
    v2, p2 = _inputs()
    assert _key(v, p) == _key(v2, p2) and hash(_key(v, p)) == hash(_key(v2, p2))
    # another Mesh object of the same shape, coordinates and groups
    assert _key(v, p) == _key(v, p, mesh=_mesh(groups=dict(_MESH.groups)))


SHARDED_CHANGES = {
    "mesh shape": lambda v, p, hp: (v, p, hp, _mesh((2, 1, 1), (0, 0, 0), dict(_MESH.groups))),
    "rank coordinate": lambda v, p, hp: (v, p, hp, _mesh((1, 2, 1), (0, 0, 0),
                                                         dict(_MESH.groups))),
    "process groups": lambda v, p, hp: (v, p, hp, _mesh()),
    "image size": lambda v, p, hp: (v, p, hp.replace(image_size=48), _MESH),
    "anti-aliasing": lambda v, p, hp: (v, p, hp.replace(anti_aliasing=False), _MESH),
    "entry": lambda v, p, hp: (v, p, hp.replace(draw_rgb=False), _MESH),
    "batch": lambda v, p, hp: (v.expand(2, -1, -1).contiguous(), p, hp, _MESH),
    "requires_grad": lambda v, p, hp: (v.clone().requires_grad_(True), p, hp, _MESH),
    "texture requires_grad": lambda v, p, hp: (
        v, nr.RasterizeParam(**{**vars(p), "textures": p.textures.clone().requires_grad_()}),
        hp, _MESH),
    "background colour": lambda v, p, hp: (
        v, nr.RasterizeParam(**{**vars(p), "background_color": (0.1, 0.2, 0.3)}), hp, _MESH),
}


@pytest.mark.parametrize("change", sorted(SHARDED_CHANGES))
def test_sharded_signature_is_new_for_a_new_mesh_hyperparameter_or_input(change):
    v, p = _inputs()
    hp = HP(image_size=32)
    v2, p2, hp2, mesh2 = SHARDED_CHANGES[change](v, p, hp)
    assert _key(v2, p2, hp2, mesh2) != _key(v, p, hp)


def test_sharded_signature_follows_the_grad_mode():
    v, p = _inputs(grad=True)
    key = _key(v, p)
    with torch.no_grad():
        assert _key(v, p) != key


# ---------------------------------------------------------------------------
# drive: a rank's work cut at its collectives


def _work(log):
    """A generator in the shape of a rank's step: a gather within one rank,
    one that reaches others, two at once, then its value."""
    log.append("a")
    (x,) = yield [(torch.ones(2), "one rank", "face_all_gather")]
    log.append(("got", x.shape))
    (y,) = yield [(x[0] * 2, "two ranks", "halo_exchange")]
    log.append(("got", y.shape))
    z = yield [(y[0], "two ranks", "face_all_gather"), (y[0], "two ranks", "face_all_gather")]
    return [t.sum() for t in z]


def test_drive_cuts_the_work_at_each_collective_that_reaches_another_rank(monkeypatch):
    monkeypatch.setattr(collectives, "crosses",
                        lambda requests: any(g == "two ranks" for _, g, _ in requests))
    log, entered, gathered = [], [], []

    @contextlib.contextmanager
    def segment(i):
        entered.append(i)
        log.append(("segment", i))
        yield
        log.append(("end", i))

    def gather(requests):
        gathered.append([kind for _, _, kind in requests])
        return [torch.stack([t, t]) for t, _, _ in requests]

    value, cuts = graphs.drive(_work(log), gather, segment)
    assert [float(v) for v in value] == [8.0, 8.0]
    assert entered == [0, 1, 2] and len(cuts) == 2
    assert gathered == [["halo_exchange"], ["face_all_gather", "face_all_gather"]]
    # the gather within one rank (t[None]) does not end a segment
    assert log == [("segment", 0), "a", ("got", (1, 2)), ("end", 0), ("segment", 1),
                   ("got", (2, 2)), ("end", 1), ("segment", 2), ("end", 2)]
    assert [len(r) for r, _ in cuts] == [1, 2] and cuts[0][1][0].shape == (2, 2)
    # without a segment context, the same value
    value, _ = graphs.drive(_work([]), gather)
    assert [float(v) for v in value] == [8.0, 8.0]


def test_drive_keeps_the_collectives_a_capture_holds_inside_the_stretch(monkeypatch):
    """Where ``inline`` accepts a list (NCCL: a capture holds it) the
    collectives are gathered where they come, inside the one stretch: no
    cut, the same value."""
    monkeypatch.setattr(collectives, "crosses",
                        lambda requests: any(g == "two ranks" for _, g, _ in requests))
    log, gathered = [], []

    @contextlib.contextmanager
    def segment(i):
        log.append(("segment", i))
        yield
        log.append(("end", i))

    def gather(requests):
        gathered.append([kind for _, _, kind in requests])
        log.append("gathered")
        return [torch.stack([t, t]) for t, _, _ in requests]

    value, cuts = graphs.drive(_work(log), gather, segment, inline=lambda requests: True)
    assert [float(v) for v in value] == [8.0, 8.0] and cuts == []
    assert gathered == [["halo_exchange"], ["face_all_gather", "face_all_gather"]]
    assert log == [("segment", 0), "a", ("got", (1, 2)), "gathered", ("got", (2, 2)),
                   "gathered", ("end", 0)]


def test_the_all_reduce_request_keeps_its_shape(monkeypatch):
    """The gradients' all-reduce (``collectives.REDUCE``) returns a tensor of
    its request's shape, where an all-gather stacks one per rank: over one
    rank, in a warm-up's stand-in and in a capture's buffer."""
    monkeypatch.setattr(collectives.dist, "get_world_size", lambda group: 3)
    t = torch.arange(5.0)
    request = (t, None, collectives.REDUCE)
    assert collectives.local(request) is t
    assert collectives.local((t, None, "halo_exchange")).shape == (1, 5)
    (zeros,) = collectives.stand_ins([request])
    (buffer,) = collectives.gathered_buffers([request])
    assert zeros.shape == buffer.shape == (5,) and not zeros.any()


def test_chain_warm_up_stands_zeros_in_for_the_collectives(monkeypatch):
    """A rank's warm-up reaches no other rank (it captures, or recaptures
    after an overflow, on its own): the results are zeros of the gathered
    shape; a capture's buffers are fresh of that shape."""
    monkeypatch.setattr(collectives.dist, "get_world_size", lambda group: 3)
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    (zeros,) = collectives.stand_ins([(t, None, "face_all_gather")])
    (buffer,) = collectives.gathered_buffers([(t, None, "face_all_gather")])
    assert zeros.shape == buffer.shape == (3, 2, 3) and not zeros.any()
    assert zeros.dtype == buffer.dtype == torch.int32


# ---------------------------------------------------------------------------
# compute_face_index_map's graph: key and route


def _faces(seed=0, bs=2, nf=40):
    rng = np.random.RandomState(seed)
    fv = rng.uniform(-1, 1, (bs, nf, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    return fv


ARGS = dict(image_size=64, near=0.1, far=100.0, draw_backside=True, row_start=0, num_rows=None,
            mode="auto")


def _index_key(faces, **kw):
    a = {**ARGS, **kw}
    static = gather_resolve.index_map_static(faces, a["image_size"], a["near"], a["far"],
                                             a["draw_backside"], a["row_start"], a["num_rows"],
                                             a["mode"])
    return gather_resolve.index_map_signature(faces, static)


INDEX_CHANGES = {
    "shape": (lambda f: f[:, :-1].contiguous(), {}),
    "batch": (lambda f: f[:1].contiguous(), {}),
    "strides": (lambda f: f.transpose(2, 3).contiguous().transpose(2, 3), {}),
    "dtype": (lambda f: f.double(), {}),
    "image_size": (lambda f: f, {"image_size": 48}),
    "near": (lambda f: f, {"near": 0.2}),
    "far": (lambda f: f, {"far": 50.0}),
    "draw_backside": (lambda f: f, {"draw_backside": False}),
    "row_start": (lambda f: f, {"row_start": 8}),
    "num_rows": (lambda f: f, {"num_rows": 16}),
    "route": (lambda f: f, {"mode": "binned"}),
}


def test_index_map_signature_is_the_same_for_the_same_call():
    f = torch.tensor(_faces())
    assert _index_key(f) == _index_key(f.clone())
    # mode "auto" keys the route the rule picks: "tiled" here
    assert _index_key(f) == _index_key(f, mode="tiled")


@pytest.mark.parametrize("change", sorted(INDEX_CHANGES))
def test_index_map_signature_is_new_for_a_new_static_argument_or_input(change):
    f = torch.tensor(_faces())
    make, kw = INDEX_CHANGES[change]
    assert _index_key(make(f), **kw) != _index_key(f)


def test_index_map_signature_follows_a_forced_route():
    f = torch.tensor(_faces())
    key = _index_key(f)
    with rc.forced_route("binned"):
        assert _index_key(f) != key


def _on_card(bs=1, nf=40):
    return types.SimpleNamespace(is_cuda=True, shape=(bs, nf, 3, 3))


def test_index_map_route(monkeypatch, caplog):
    """"graph" on the card, "eager" on the CPU, under eager() and under
    plain_versions (each said through note_eager), "inline" inside a
    capture and inside a graph's own warm-up (the sharded chain's)."""
    monkeypatch.setattr(graphs, "capturing", lambda: False)
    assert graphs.route(_on_card(), None, None) == "graph"
    assert graphs.route(torch.zeros(1, 4, 3, 3), None, None) == "eager"
    with nr.eager():
        assert graphs.route(_on_card(), None, None) == "eager"
    with rc.plain_versions():
        assert graphs.route(_on_card(), None, None) == "eager"
    with graphs.rendering(graphs.INDEX_MAPS, object()):
        assert graphs.route(_on_card(), None, None) == "inline"
        with nr.eager():
            assert graphs.route(_on_card(), None, None) == "eager"
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    assert graphs.route(_on_card(), None, None) == "inline"
    graphs.note_eager.cache_clear()
    with caplog.at_level(logging.INFO, logger=graphs.__name__):
        nr.compute_face_index_map(torch.tensor(_faces()), 32)
    assert any("compute_face_index_map" in r.getMessage() and "eager" in r.getMessage()
               for r in caplog.records)


class _Replayed:
    """A stand-in for a captured Graph: records its calls, returns fixed
    outputs."""

    def __init__(self, out):
        self.out, self.calls = out, 0

    def __call__(self, faces):
        self.calls += 1
        return self.out


def test_index_map_on_the_card_goes_through_its_cached_graph(monkeypatch):
    """The entry keys its graph by index_map_signature under INDEX_MAPS:
    the first call (no graph yet) runs the resolve, a later one returns the
    replay's outputs (index, and depth with return_depth)."""
    f = torch.tensor(_faces())
    monkeypatch.setattr(gather_resolve, "route", lambda *a: "graph")
    asked = []
    replayed = _Replayed(None)

    def cached_graph(record, signature, capture, label):
        asked.append((record, signature, label))
        return replayed if len(asked) > 1 else None

    monkeypatch.setattr(gather_resolve, "cached_graph", cached_graph)
    want = nr.compute_face_index_map(f, 64, row_start=8, num_rows=20, return_depth=True)
    replayed.out = (want[0] + 1, want[1])
    got = nr.compute_face_index_map(f, 64, row_start=8, num_rows=20)
    assert torch.equal(got, want[0] + 1) and replayed.calls == 1
    (r1, s1, label), (r2, s2, _) = asked
    assert r1 is r2 is graphs.INDEX_MAPS and s1 == s2 == _index_key(f, row_start=8, num_rows=20)
    assert "compute_face_index_map" in label


# ---------------------------------------------------------------------------
# compute_face_index_map inside a capture: the binned route's capacity


def test_index_map_inside_a_capture_takes_the_capped_bins_of_its_last_eager_call(monkeypatch):
    """Outside any render the binnings' totals are kept on INDEX_MAPS: an
    eager call keeps its total, and the same call inside a capture (or a
    graph's warm-up) bins in K7's capped form at twice it, to the eager
    bits; a call whose binning ran eagerly nowhere raises."""
    f = torch.tensor(_faces(3, 2, 60))
    calls = []
    bin_faces = rc.bin_faces
    monkeypatch.setattr(rc, "bin_faces", lambda *a, **kw: calls.append(kw.get("capacity"))
                        or bin_faces(*a, **kw))
    want = nr.compute_face_index_map(f, 48, row_start=4, num_rows=30, return_depth=True,
                                     mode="binned")
    key = ((2, 3, 3, 60), 48, 4, 30, True)
    total = graphs.INDEX_MAPS.bin_totals[key]
    assert calls == [None] and total > 0
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    got = nr.compute_face_index_map(f, 48, row_start=4, num_rows=30, return_depth=True,
                                    mode="binned")
    assert calls == [None, graphs.bin_capacity(total)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="run the step once before capturing"):
        nr.compute_face_index_map(f, 48, row_start=5, num_rows=30, mode="binned")


# ---------------------------------------------------------------------------
# the id/depth entry against the JAX package's jitted entry


@pytest.mark.parametrize("mode", ["tiled", "binned"])
@pytest.mark.parametrize("window", [(0, None), (20, 17), (50, 30)])
def test_index_map_matches_the_jitted_jax_entry(mode, window):
    """The port's entry (the resolve its graph holds) against the JAX
    package's ``compute_face_index_map``, which jits these arguments
    static: index maps equal (rows past the bottom background), depth
    equal to the eager JAX resolve (jitted XLA contracts ``zp``)."""
    fv = _faces(7, 2, 50)
    row_start, num_rows = window
    kw = dict(row_start=row_start, num_rows=num_rows)
    index, depth = nr.compute_face_index_map(torch.tensor(fv), 64, return_depth=True, mode=mode,
                                             **kw)
    want = np.asarray(jres.compute_face_index_map(jnp.asarray(fv), 64, **kw))
    with jax.disable_jit():
        _, want_depth = jres.compute_face_index_map(jnp.asarray(fv), 64, return_depth=True, **kw)
    np.testing.assert_array_equal(index.numpy(), want)
    np.testing.assert_array_equal(depth.numpy(), np.asarray(want_depth))
    assert (want >= 0).any()
