"""Kernel K4's vertex -> slot table (``resolve_cuda.build_vertex_slots``, kept
per faces tensor by ``resolve_cuda.vertex_slots``) and the sum the kernel
takes over it, on the CPU: each vertex sums its own slots in ascending
order from 0, which is the order of the plain version's ``index_add_`` on
the CPU, so the card's result is the plain version's bits.  Also the
``Renderer``'s default device, against the JAX package's ``Renderer()``."""

import gc

import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu.models.renderer import Renderer as JaxRenderer
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops.gather_resolve import gather_face_vertices
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import icosphere, torus

CASES = ["icosphere", "torus", "out_of_range"]


def _faces(case):
    """(faces i32 [nf, 3], nv) of a named case."""
    if case == "icosphere":
        v, f = icosphere(2)
        return f, len(v)
    if case == "torus":
        v, f = torus(16, 12)
        return f, len(v)
    # ids below 0, at nv and past it, a face of them only, and a vertex (17)
    # that no face names
    f = np.random.RandomState(7).randint(0, 40, (90, 3)).astype(np.int32)
    f[f == 17] = 18
    f[3, 1], f[10, 0], f[11, 2], f[20] = -1, 40, 1000, -5
    return f, 40


def _gradient(seed, bs, nf):
    return torch.tensor(100 * np.random.RandomState(seed).randn(bs, 3, 3, nf).astype(np.float32))


def _sequential_sum(g, faces, nv):
    """out[b, v, c] summed slot after slot (s = 3 f + k ascending) from 0,
    ids outside [0, nv) skipped: the order the kernel keeps per vertex."""
    bs, nf = g.shape[0], g.shape[-1]
    rows = g.permute(0, 3, 2, 1).reshape(bs, 3 * nf, 3).numpy()
    out = np.zeros((bs, nv, 3), np.float32)
    for s, v in enumerate(faces.reshape(-1)):
        if 0 <= v < nv:
            out[:, v] += rows[:, s]
    return torch.tensor(out)


def _kernel_sum(g, offsets, slots, nv):
    """The kernel's loop on the CPU, vectorised over vertices: step j adds
    every vertex's j-th slot of the table to its running sum from 0."""
    bs, nf = g.shape[0], g.shape[-1]
    rows = g.permute(0, 3, 2, 1).reshape(bs, 3 * nf, 3)
    start, degree = offsets[:-1].long(), (offsets[1:] - offsets[:-1]).long()
    acc = torch.zeros((bs, nv, 3))
    for j in range(int(degree.max())):
        live = degree > j
        s = slots.long()[torch.where(live, start + j, 0)]
        acc = torch.where(live[None, :, None], acc + rows[:, s], acc)
    return acc


@pytest.mark.parametrize("case", CASES)
def test_every_in_range_slot_once_ascending_within_its_vertex(case):
    f, nv = _faces(case)
    offsets, slots = rc.build_vertex_slots(torch.tensor(f), nv)
    assert offsets.dtype == slots.dtype == torch.int32
    assert offsets.shape == (nv + 1,) and slots.shape == (f.size,)
    ids = f.reshape(-1)
    valid = (ids >= 0) & (ids < nv)
    o, s = offsets.numpy(), slots.numpy()
    assert o[0] == 0 and o[-1] == valid.sum() and (np.diff(o) >= 0).all()
    for v in range(nv):
        np.testing.assert_array_equal(s[o[v]:o[v + 1]], np.flatnonzero(ids == v))
    # every slot once; those of out-of-range ids after offsets[nv], owned by none
    np.testing.assert_array_equal(np.sort(s), np.arange(f.size))
    np.testing.assert_array_equal(np.sort(s[o[-1]:]), np.flatnonzero(~valid))


@pytest.mark.parametrize("bs", [1, 3])
@pytest.mark.parametrize("case", ["icosphere", "torus"])
def test_index_add_in_table_order_is_the_plain_versions_bits(case, bs):
    f, nv = _faces(case)
    faces, g = torch.tensor(f), _gradient(bs, bs, len(f))
    want = rc.scatter_faces_to_vertices_plain(g, faces, nv)
    offsets, slots = rc.build_vertex_slots(faces, nv)
    owned = slots[:int(offsets[-1])].long()
    rows = g.permute(0, 3, 2, 1).reshape(bs, 3 * len(f), 3)
    got = torch.zeros((bs, nv, 3)).index_add_(1, faces.reshape(-1).long()[owned], rows[:, owned])
    assert torch.equal(got, want)
    assert torch.equal(_sequential_sum(g, f, nv), want)


@pytest.mark.parametrize("case", CASES)
def test_kernel_loop_over_the_table_is_the_sequential_sum(case):
    """The kernel's per-vertex loop gives the slot-after-slot sum's bits,
    out-of-range ids adding nothing and a vertex without slots 0; where
    every id is in range that is the plain version's result."""
    f, nv = _faces(case)
    faces, g = torch.tensor(f), _gradient(5, 2, len(f))
    got = _kernel_sum(g, *rc.build_vertex_slots(faces, nv), nv)
    assert torch.equal(got, _sequential_sum(g, f, nv))
    if case == "out_of_range":
        assert (got[:, 17] == 0).all()
    else:
        assert torch.equal(got, rc.scatter_faces_to_vertices_plain(g, faces, nv))


def test_slot_table_is_kept_per_faces_tensor():
    f, nv = _faces("torus")
    faces = torch.tensor(f)
    rc.reset_launches()
    first = rc.vertex_slots(faces, nv)
    assert rc.vertex_slots(faces, nv) is first and rc.SLOT_TABLE_BUILDS == 1
    other = rc.vertex_slots(torch.tensor(f), nv)           # the same ids, another tensor
    assert other is not first and rc.SLOT_TABLE_BUILDS == 2
    assert all(torch.equal(a, b) for a, b in zip(first, other))
    rc.vertex_slots(faces, nv + 1)                           # another vertex count
    assert rc.SLOT_TABLE_BUILDS == 3
    faces[0] = faces[1]                                      # an in-place edit
    edited = rc.vertex_slots(faces, nv)
    assert rc.SLOT_TABLE_BUILDS == 4
    assert all(torch.equal(a, b) for a, b in zip(edited, rc.build_vertex_slots(faces, nv)))
    assert not torch.equal(edited[1], first[1])
    assert rc.vertex_slots(faces, nv) is edited and rc.SLOT_TABLE_BUILDS == 4


def test_slot_table_leaves_with_its_tensor():
    faces = torch.tensor(torus(8, 6)[1])
    key = id(faces)
    rc.vertex_slots(faces, 48)
    assert key in rc._slot_tables
    del faces
    gc.collect()
    assert key not in rc._slot_tables


def test_k4_wrapper_launches_over_the_kept_table(monkeypatch):
    """With CUDA pretended, every K4 call passes the one table's pointers
    and writes into an output it does not zero."""
    launched = []
    monkeypatch.setattr(rc, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(rc, "_launch", lambda name, index, *args: launched.append(args))
    f, nv = _faces("icosphere")
    faces, g = torch.tensor(f), _gradient(0, 2, len(f))
    rc.reset_launches()
    for _ in range(3):
        assert rc.scatter_faces_to_vertices(g, faces, nv).shape == (2, nv, 3)
    offsets, slots = rc.vertex_slots(faces, nv)
    assert rc.SLOT_TABLE_BUILDS == 1 and len(launched) == 3
    for args in launched:
        assert args[:3] == (g.data_ptr(), offsets.data_ptr(), slots.data_ptr())
        assert args[4:] == (2, len(f), nv)


def test_fit_steps_share_one_slot_table(monkeypatch):
    """The face-vertex gather saves the faces tensor itself for its
    backward, so every step of a fit finds the table its first step built."""
    monkeypatch.setattr(rc, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(rc, "_launch", lambda name, index, *args: None)
    v, f = icosphere(1)
    faces = torch.tensor(f)
    x = torch.tensor(v[None], requires_grad=True)
    rc.reset_launches()
    for _ in range(3):
        gather_face_vertices(x, faces).sum().backward()
    assert rc.SLOT_TABLE_BUILDS == 1


def test_renderer_runs_on_the_card_unless_asked_for_the_cpu():
    """``Renderer()`` is called as the JAX package's is, with its camera and
    rendering defaults, and renders on the current card; ``"cpu"`` takes
    the plain versions."""
    port, jax_renderer = nr.Renderer(), JaxRenderer()
    assert port.device == torch.device("cuda")
    assert nr.Renderer("cpu").device == torch.device("cpu")
    for name in ("image_size", "anti_aliasing", "draw_backside", "background_color",
                 "perspective", "viewing_angle", "viewpoints", "camera_mode",
                 "camera_direction", "near", "far"):
        assert getattr(port, name) == getattr(jax_renderer, name), name
    with pytest.raises(ValueError, match="renderer on cuda"):
        port.render_silhouettes(torch.zeros(1, 3, 3), [[0, 1, 2]])


@pytest.mark.parametrize("form", ["numpy", "list"])
def test_renderer_keeps_array_like_faces_on_its_device(form):
    """Array-like faces, passed anew at every step as the JAX package's
    ``Renderer`` is called, give one kept tensor (and so one slot table)
    while their ids stay the same; an in-place edit gives a new one."""
    f = _faces("torus")[0]
    faces = f.copy() if form == "numpy" else f.tolist()
    r = nr.Renderer("cpu")
    kept = r.faces_on_device(faces)
    assert kept.dtype == torch.int32 and torch.equal(kept, torch.tensor(f))
    assert r.faces_on_device(faces) is kept
    assert r.faces_on_device(np.array(f, np.int64)) is kept       # the same ids
    if form == "numpy":
        faces[0] = faces[1]
    else:
        faces[0] = list(faces[1])
    edited = r.faces_on_device(faces)
    assert edited is not kept and torch.equal(edited[0], edited[1])
    assert torch.equal(kept, torch.tensor(f))                    # the old copy is intact


def test_renderer_passes_tensor_faces_through():
    """A tensor on the renderer's device is used as it is, of any integer
    dtype: the rasterizer keeps one int32 copy per faces tensor
    (``ops/graphs.py``), so int64 faces convert once, not at each call."""
    f = torch.tensor(_faces("torus")[0])
    r = nr.Renderer("cpu")
    assert r.faces_on_device(f) is f
    f64 = f.long()
    assert r.faces_on_device(f64) is f64
    from neural_renderer_v2_pytorch_tpu_torch.ops import graphs

    converted = graphs.faces_record(f64).faces
    assert converted.dtype == torch.int32 and torch.equal(converted, f)
    assert graphs.faces_record(f64).faces is converted
