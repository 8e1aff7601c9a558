"""The port's measurement modules (``neural_renderer_v2_pytorch_tpu_torch.
benchmarks``) on the CPU, where they run the kernels' plain versions and
time nothing:

- ``bench``'s chain (``steps.run_chain``, the steps that the card replays
  from one captured graph) against the same chain through the JAX package
  (``bench.py``'s ``look_at``/``perspective``/``rasterize_silhouettes``,
  loss and update), run eagerly: each step's gradient within 1e-4 of its
  largest magnitude, how far the vertices moved within 1e-4 of the most
  they moved plus one float32 spacing, the vertices within the golden
  tolerance (rtol 1e-5, atol 1e-7), losses within 1e-6 relative;
- ``measure_time``'s four functions against the JAX package's (its
  ``benchmarks/measure_time.py``): index maps equal, images within 1e-6,
  gradients within 1e-4 of their largest magnitude;
- ``scaling``'s thirteen rows, their face counts and routes, and a step of
  each kind of row at a small size;
- ``roofline``'s counts: exact on a one-triangle scene, and the same
  whichever route or kernel flag is forced; K6's over the atlas's step,
  and its library call against the plain version;
- ``kernel_census``'s operations of one eager step, the same over two runs,
  and ``prof``'s stages of one step, in order, and K6's in the atlas's
  gradient step;
- a profile that kept no device record reads "not measured" (None), not 0;
- each module's ``main()`` without a card: status 2 and one line.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu as jnr
from neural_renderer_v2_pytorch_tpu.ops import camera as jcam
from neural_renderer_v2_pytorch_tpu.ops import rasterize as jras
from neural_renderer_v2_pytorch_tpu.ops.resolve import compute_face_index_map as jax_index_map
from neural_renderer_v2_pytorch_tpu_torch.benchmarks import (
    bench,
    kernel_census,
    measure_time,
    prof,
    roofline,
    scaling,
    steps,
)
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops.gather_resolve import compute_face_index_map
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import atlas_scene, torus

SIZE = 32
CHAIN_STEPS = 3


@pytest.fixture(scope="module")
def mesh():
    return torus(12, 8)


def _jax_bench_chain(v, f, size, n):
    """bench.py's step, run ``n`` times eagerly: (vertices, [loss],
    [gradient])."""
    eye = np.array(jnr.get_points_from_angles(2.732, 30, 0), "float32")
    hp = jras.RasterizeHyperparam(image_size=size)

    def loss_fn(x):
        tv = jcam.perspective(jcam.look_at(x, eye), angle=30.0)
        images = jras.rasterize_silhouettes(tv, f, None, hp)
        return jnp.sum(images * images) / (jnp.sum(images) + 1.0)

    x, losses, grads = jnp.asarray(v[None]), [], []
    with jax.disable_jit():
        for _ in range(n):
            loss, grad = jax.value_and_grad(loss_fn)(x)
            x = x - 1e-6 * grad
            losses.append(float(loss))
            grads.append(np.asarray(grad))
    return np.asarray(x), losses, grads


def test_bench_chain_matches_the_jax_chain(mesh):
    v, f = mesh
    scene = steps.Silhouettes(v, f, SIZE, device="cpu")
    assert np.array_equal(scene.eye.numpy(),
                          np.array(jnr.get_points_from_angles(2.732, 30, 0), "float32"))
    (got,), losses, grads = steps.run_chain(scene.case("bench"), CHAIN_STEPS)
    want, want_losses, want_grads = _jax_bench_chain(v, f, SIZE, CHAIN_STEPS)
    # the gradient each update takes: a zero, flipped or scaled one fails
    for (g,), w in zip(grads, want_grads):
        assert np.abs(w).max() > 0
        _close(g.numpy(), w, 1e-4)
    # the update: the update moves a vertex by a few float32 spacings, so
    # the values alone (below) cannot tell a wrong one; how far each vertex
    # moved can, within one spacing for the rounding of either side
    got, start = got.numpy(), v[None]
    moved, want_moved = got - start, want - start
    assert np.abs(moved).max() > 0 and np.abs(want_moved).max() > 0
    spacing = np.spacing(np.maximum(np.abs(start), np.abs(want)))
    assert (np.abs(moved - want_moved) <= 1e-4 * np.abs(want_moved).max() + spacing).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)


def test_bench_scene_is_the_torus_obj():
    scene = bench.scene("cpu")
    assert scene.faces.shape == (2560, 3) and scene.faces.dtype == torch.int32
    assert scene.values[0].shape == (1, 1280, 3) and scene.size == 512


def test_bench_baseline_only_for_its_own_workload():
    """vs_baseline divides only by a baseline of the same faces, image size
    and batch."""
    assert bench.baseline(2560, 256, 1) > 0
    for other in ((2464, 256, 1), (2560, 512, 1), (2560, 256, 8)):
        assert bench.baseline(*other) is None


def _jax_measure_functions(scene, eye):
    """The JAX package's measure_time functions at ``eye``: (silhouettes,
    vertex gradient, RGB, (vertex gradient, atlas gradient)), and the
    index map."""
    v, f = scene.vertices.numpy(), scene.faces.numpy()
    vt, ft, tex = scene.vt.numpy(), scene.ft.numpy(), scene.textures.numpy()
    hp = jras.RasterizeHyperparam(image_size=scene.hp.image_size)

    def camera(x):
        return jcam.perspective(jcam.look_at(x, eye), angle=30.0)

    def rgb(x, t):
        p = jras.RasterizeParam(vertices_textures=jnp.asarray(vt), faces_textures=jnp.asarray(ft),
                                textures=t, texture_size=scene.texture_size)
        return jras.rasterize_rgb(camera(x), f, p, hp)

    with jax.disable_jit():
        x, t = jnp.asarray(v), jnp.asarray(tex)
        out = (jras.rasterize_silhouettes(camera(x), f, None, hp),
               jax.grad(lambda x: jnp.sum(jras.rasterize_silhouettes(camera(x), f, None, hp)
                                          ** 2))(x),
               rgb(x, t),
               jax.grad(lambda x, t: jnp.sum(rgb(x, t) ** 2), argnums=(0, 1))(x, t))
        index = jax_index_map(jnp.take(camera(x), f, axis=1), 2 * scene.hp.image_size)
    return jax.tree_util.tree_map(np.asarray, out), np.asarray(index)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def test_measure_time_functions_match_jax(mesh):
    v, f = mesh
    scene = measure_time.Scene(v, f, SIZE, texture_size=2, iters=2, device="cpu")
    assert len(scene.eyes) == 2
    for eye in scene.eyes:
        (sil, sil_grad, rgb, (rgb_v, rgb_t)), want_index = _jax_measure_functions(
            scene, eye.numpy())
        with torch.no_grad():
            ndc = scene.camera(scene.vertices, eye)
            index = compute_face_index_map(ndc[:, scene.faces.long()], 2 * SIZE)
        np.testing.assert_array_equal(index.numpy(), want_index)
        assert (want_index >= 0).any()
        _close(measure_time.silhouette_forward(scene, eye).numpy(), sil, 1e-6)
        _close(measure_time.silhouette_backward(scene, eye).numpy(), sil_grad, 1e-4)
        _close(measure_time.textured_forward(scene, eye).numpy(), rgb, 1e-6)
        got_v, got_t = measure_time.textured_backward(scene, eye)
        _close(got_v.numpy(), rgb_v, 1e-4)
        _close(got_t.numpy(), rgb_t, 1e-4)


def test_scaling_has_the_perf_matrix_rows():
    rows = scaling.ROWS
    assert len(rows) == 13 and len({r.label for r in rows}) == 13
    assert [scaling.num_faces(r) for r in rows] == [2560] * 8 + [
        10240, 40960, 163840, 655360, 163840]
    assert [scaling.route(r) for r in rows] == (
        ["tiled"] * 2 + ["binned"] + ["tiled"] * 6 + ["binned"] * 4)
    assert [r.batch for r in rows[:3]] == [1, 8, 30]
    assert set(scaling.QUICK) <= {r.label for r in rows} and len(scaling.QUICK) == 3
    for level in (0, 1, 2):
        v, f = scaling.mesh(level)
        assert f.shape[0] == scaling.num_faces(rows[7 + level]) and f.max() < len(v)


@pytest.mark.parametrize("label", [scaling.ROWS[i].label for i in (1, 4, 5, 6, 12)])
def test_scaling_row_steps_at_a_small_size(label):
    """A step of each kind of row (silhouettes over views, textured with
    lights, the atlas's vertices and its own gradients, textured without
    anti-aliasing), cut to 16^2, 2 views and the torus itself."""
    row = next(r for r in scaling.ROWS if r.label == label)
    row = row._replace(image_size=16, batch=min(row.batch, 2), level=0)
    images, grads = scaling.case(row, "cpu").step()
    assert images.shape[0] == row.batch and torch.isfinite(images).all()
    (g,) = grads
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


def test_roofline_counts_one_triangle():
    ndc = torch.tensor([[[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0]]])
    faces = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    # 8^2 pixels: centres at +-0.125, +-0.375 lie in the bbox (4 x 4 tests),
    # 4 + 2 + 2 of them in the triangle
    assert roofline.step_work(ndc, faces, 8) == {
        "face-vertex gather (K5)": (12 * 3 + 12 + 36, 0),
        "resolve (K2, or K7 + K8)": (36 + 4 * 8 * 64, 30 * 16),
        "pixel -> face scatter (K3)": (4 * 64 + 4 * 6 * 8 + 4 * 6, 6 * 8),
        "vertex gradient sum (K4)": (36 + 12 + 36, 9),
    }
    assert roofline.bound(3.35e9, 0) == (1.0, "bytes")
    assert roofline.bound(0, 67e9) == (1.0, "operations")


@pytest.mark.parametrize("flag", ["binned", "tiled", "plain"])
def test_roofline_counts_do_not_depend_on_the_route(mesh, flag):
    v, f = mesh
    scene = steps.Silhouettes(v, f, SIZE, device="cpu")
    with torch.no_grad():
        ndc = scene.camera(scene.values[0])
    want = roofline.step_work(ndc, scene.faces, scene.size)
    ctx = rc.plain_versions() if flag == "plain" else rc.forced_route(flag)
    with ctx:
        assert roofline.step_work(ndc, scene.faces, scene.size) == want
    assert all(nbytes > 0 for nbytes, _ in want.values())


def test_census_repeats_its_operations(mesh):
    v, f = mesh
    case = steps.Silhouettes(v, f, SIZE, device="cpu").case("bench")
    first = kernel_census.eager_form(case, "cpu")[1]
    second = kernel_census.eager_form(case, "cpu")[1]
    assert first == second
    assert first["launches"] == {}                 # no kernel on the CPU
    assert sum(first["dispatched"].values()) > 100


def test_prof_names_every_stage_in_order(mesh):
    v, f = mesh
    ops = prof.stage_ops(steps.Silhouettes(v, f, SIZE, device="cpu").case("bench"))
    assert list(ops) == [
        "camera", "gather", "resolve", "planes", "pool", "loss", "loss.vjp", "pool.vjp",
        "nmr.grad", "nmr.grad.y", "nmr.grad.x", "planes.vjp", "resolve.vjp", "gather.vjp",
        "camera.vjp", "update"]
    # look_at and perspective each hold a camera span, forward and backward
    assert ops["camera"] == ops["camera.vjp"] == 2
    assert all(n == 1 for s, n in ops.items() if not s.startswith("camera"))
    # without anti-aliasing the flip's own VJP is the pool's span
    no_aa = prof.stage_ops(steps.Silhouettes(v, f, SIZE, anti_aliasing=False,
                                             device="cpu").case("level"))
    assert list(no_aa) == list(ops)


def test_prof_names_the_atlas_gradient_stage():
    """The atlas's gradient step (its row cut to 16^2): K6's span
    (``_AtlasTaps.backward``) is the last before the update; prof runs that
    step beside bench's."""
    assert list(prof.cases("cpu")) == ["bench", prof.ATLAS_ROW]
    row = next(r for r in scaling.ROWS if r.label == prof.ATLAS_ROW)
    ops = prof.stage_ops(scaling.case(row._replace(image_size=16), "cpu"))
    assert list(ops)[-2:] == [prof.ATLAS_STAGE, "update"] and ops[prof.ATLAS_STAGE] > 0
    assert prof.ATLAS_STAGE == "atlas.vjp"


def test_roofline_counts_the_atlas_gradient():
    """K6's bytes and adds over anchors -1, 0, 5, T - 1 and T (T = 10):
    three covered pixels; and, on the atlas's gradient step at 32^2, the
    anchors read from its graph (one per covered pixel, -1 elsewhere) and
    the library call, which equals the plain version there."""
    anchors = torch.tensor([[-1, 0, 5, 9, 10]], dtype=torch.int32)
    assert roofline.atlas_taps_work(anchors, 10) == (4 * 5 + 48 * 3 + 12 * 10, 12 * 3)
    row = next(r for r in scaling.ROWS if r.label == prof.ATLAS_ROW)
    case = scaling.case(row._replace(image_size=32), "cpu")
    images = case.forward(*(v.clone().requires_grad_(True) for v in case.values))
    anchors, tw, T = roofline.atlas_taps_inputs(images)
    assert (tw, T) == (1920, 1190 * 1920) and anchors.shape == (1, 64 * 64)
    ndc = case.renderer.transform_vertices(torch.tensor(atlas_scene(*scaling.TORUS)[0][None]))
    index = compute_face_index_map(ndc[:, case.faces.long()], 64)
    assert torch.equal(anchors >= 0, index.reshape(1, -1) >= 0)
    assert roofline.atlas_taps_work(anchors, T) == (
        4 * 64 * 64 + 48 * int((index >= 0).sum()) + 12 * T, 12 * int((index >= 0).sum()))
    grad = torch.tensor(np.random.RandomState(0).randn(1, 12, 64 * 64).astype(np.float32))
    want = rc.atlas_taps_grad_plain(grad, anchors, tw, T)
    got = roofline.atlas_taps_library(grad, anchors, tw, T)()
    torch.testing.assert_close(got, want[0], rtol=0, atol=1e-6 * float(want.abs().max()))


def _profile(records):
    """A ``steps.Profile`` with these ``records`` (name -> (records per
    call, mean record ms)) and nothing else kept."""
    fields = dict.fromkeys(steps.Profile._fields)
    fields.update(records=records, ops=sum(n for n, _ in records.values()))
    return steps.Profile(**fields)


def test_a_profile_that_kept_no_record_is_not_measured(monkeypatch):
    """``call_device_ms``: None for a profile that kept no record, never 0;
    else each name's mean record times its records per call rounded (at
    least 1).  ``roofline.graph_device_ms`` profiles again while nothing
    was kept, up to STAGE_ATTEMPTS times, then reads None."""
    assert steps.call_device_ms(_profile({})) is None
    assert steps.call_device_ms(_profile({"k": (2.0, 0.25), "fill": (0.4, 0.5)})) == 1.0
    taken = []

    def profiles(kept):
        def profile_device(step, n):
            taken.append(n)
            return _profile({"k": (1.0, 0.5)} if len(taken) == kept else {})
        return profile_device

    monkeypatch.setattr(roofline, "graphed", lambda calls: lambda: None)
    monkeypatch.setattr(steps, "profile_device", profiles(2))
    assert roofline.graph_device_ms([None, None], 5) == 0.25 and taken == [5, 5]
    taken.clear()
    monkeypatch.setattr(steps, "profile_device", profiles(0))
    assert roofline.graph_device_ms([None], 5) is None
    assert len(taken) == roofline.STAGE_ATTEMPTS


@pytest.mark.parametrize("module", [bench, measure_time, scaling, prof, kernel_census, roofline],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_without_a_card_says_so_and_exits_2(module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    status = module.main() if module is bench else module.main([])
    out = capsys.readouterr().out
    assert status == steps.NO_CARD == 2
    assert len(out.splitlines()) == 1 and "needs a CUDA card" in out
    with pytest.raises(json.JSONDecodeError):
        json.loads(out)
