"""The port's binned resolve route (K7's bins, then K8's three resolve forms,
through their plain versions on the CPU), its row windows and weight maps,
against the JAX package.

- ``bin_faces_plain`` against JAX's ``_bin_faces`` (its XLA prepass):
  counts equal and each bin's ids equal in order.  JAX's order is a full
  permutation of the faces, so only each tile's first ``cnt`` ids count.
- The binned route against JAX's ``_binned_kernel`` in interpret mode
  (``resolve_gather_pallas`` / ``compute_face_index_map_pallas`` with
  ``mode="binned"``): index, latched coordinates and attributes bit-equal;
  depth bit-equal to the eager XLA resolve (the interpret-mode kernel's
  depth carries XLA:CPU's multiply-add contraction).  Those JAX kernels compute pixel centres as ``(2i + 1 - S) *
  (1/S)``, the port divides by S, so they are compared at powers of two;
  at S = 100 the port is held to JAX's XLA resolve, which divides.
- The slice end to end with the binned route forced, against the eager JAX
  pipeline (``jax.disable_jit``), with ``tests/test_torch_rgb.py``'s
  tolerances: index maps equal, images within 1e-6, gradients rtol 1e-5
  and atol 1e-6 of the largest; and the two routes bit-equal.

The soup is ``tests/test_resolve_pallas.py``'s: an odd face count, a
duplicate face and a degenerate edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu_torch as tnr
from neural_renderer_v2_pytorch_tpu.ops import resolve as jres
from neural_renderer_v2_pytorch_tpu.ops.rasterize import RasterizeHyperparam as JaxHP
from neural_renderer_v2_pytorch_tpu.ops.resolve_pallas import (
    _bin_faces,
    compute_face_index_map_pallas,
    resolve_gather_pallas,
)
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve as tres
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops.gather_resolve import (
    compute_face_index_map,
    resolve_and_gather,
)
# the silhouette and textured harnesses of the end-to-end tests
from test_torch_rasterize import _jax_image_and_grads, _jax_scene, _port_image_and_grads
from test_torch_rasterize import _target as _silhouette_target
from test_torch_rgb import LIT, _assert_grads, _jax_render, _port_render, _scene
from test_torch_rgb import _target as _rgb_target


def _soup(seed=11, bs=2, nf=71):
    rng = np.random.RandomState(seed)
    fv = rng.uniform(-1, 1, size=(bs, nf, 3, 3)).astype("float32")
    fv[..., 2] = np.abs(fv[..., 2]) + 0.3
    fv[:, 5] = fv[:, 3]          # duplicate face
    fv[:, 7, 1] = fv[:, 7, 0]    # degenerate edge
    return fv


def _planar(fv):
    return torch.tensor(np.ascontiguousarray(fv.transpose(0, 3, 2, 1)))


@pytest.mark.parametrize("draw_backside", [True, False])
@pytest.mark.parametrize("window", [(64, 0, None), (128, 0, None), (128, 64, 64)])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_bins_match_jax(seed, window, draw_backside):
    """At the port's one tile (8x8), which JAX's ``_bin_faces`` takes as
    well, on three soups."""
    S, row_start, num_rows = window
    rows = S if num_rows is None else num_rows
    th, tw = rc.BIN_TILE
    fv = _soup(seed)
    bs, nf = fv.shape[:2]
    # JAX tiles its padded canvas: rows to 8, width to 128
    jax_tx = -(-S // 128) * 128 // tw
    ty_n, tx_n = -(-rows // th), -(-S // tw)
    order, jcnt = _bin_faces(jres.face_constants(jnp.asarray(fv)), S, ty_n, jax_tx, th, tw,
                             draw_backside, row_start=row_start)
    # the tiles both sides have; where JAX's reach into its padding, a face
    # wholly past the last pixel centre would be binned by JAX alone
    last_centre = (2 * S - 1 - S) / S
    assert (fv[..., 0].min(-1) <= last_centre).all()
    jcnt = np.asarray(jcnt).reshape(bs, ty_n, jax_tx)[:, :, :tx_n].reshape(bs, -1)
    order = np.asarray(order).reshape(bs, ty_n, jax_tx, nf)[:, :, :tx_n].reshape(bs, -1, nf)

    cnt, offsets, ids = (t.numpy() for t in rc.bin_faces(_planar(fv), draw_backside, S,
                                                         row_start, num_rows))
    np.testing.assert_array_equal(cnt, jcnt)
    assert cnt.sum() > 0
    for b in range(bs):
        for t in range(ty_n * tx_n):
            np.testing.assert_array_equal(ids[offsets[b, t]:offsets[b, t] + cnt[b, t]],
                                          order[b, t, :cnt[b, t]])


@pytest.mark.parametrize("seed", [3, 8])
@pytest.mark.parametrize("size,window", [(17, (0, None)), (100, (0, None)), (100, (37, 41))])
def test_bins_hold_exactly_the_faces_that_touch_each_tile(size, window, seed):
    """Ragged canvases and windows (where the JAX tiles differ): each bin is
    the faces passing K2's strict tile test, in ascending order."""
    row_start, num_rows = window
    rows = size if num_rows is None else num_rows
    th, tw = rc.BIN_TILE
    fvp = _planar(_soup(seed, 2, 90))
    cnt, offsets, ids = rc.bin_faces(fvp, True, size, row_start, num_rows)
    c = rc.face_setup(fvp, True).numpy()
    f32 = np.float32

    def centre(i):
        return (f32(2) * f32(i) + f32(1) - f32(size)) / f32(size)

    t = 0
    for r0 in range(0, rows, th):
        for c0 in range(0, size, tw):
            x_lo, x_hi = centre(c0), centre(min(c0 + tw, size) - 1)
            y_lo = centre(row_start + r0)
            y_hi = centre(row_start + min(r0 + th, rows) - 1)
            for b in range(2):
                hit = ~((c[b, 14] < x_lo) | (x_hi < c[b, 13]) | (c[b, 16] < y_lo)
                        | (y_hi < c[b, 15]))
                got = ids[offsets[b, t]:offsets[b, t] + cnt[b, t]].numpy()
                np.testing.assert_array_equal(got, np.flatnonzero(hit))
            t += 1
    assert t == cnt.shape[1] and len(ids) == int(cnt.sum())


@pytest.mark.parametrize("window", [(0, None), (37, 41)])
@pytest.mark.parametrize("seed", [6, 9])
def test_binned_forms_at_each_tile_equal_the_tiled_forms(seed, window):
    """K8's three forms (plain versions) over the bins of its 8x8 tiles, on
    a ragged canvas and two soups: the tiled forms' bits."""
    fvp = _planar(_soup(seed, 2, 80))
    attrs = torch.tensor(np.random.RandomState(7).rand(2, 80, 5).astype(np.float32))
    args = (100, 0.1, 100.0, *window)
    bins = rc.bin_faces(fvp, True, 100, *window)
    pairs = [
        (rc.resolve_binned_xy(fvp, True, bins, *args), rc.resolve_xy(fvp, True, *args)),
        (rc.resolve_binned_latch(fvp, attrs, True, bins, *args),
         rc.resolve_latch(fvp, attrs, True, *args)),
        (rc.resolve_binned_depth(fvp, True, bins, *args), rc.resolve_depth(fvp, True, *args)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (pairs[0][1][0] >= 0).any()


@pytest.mark.parametrize("latch_z", [False, True])
@pytest.mark.parametrize("draw_backside", [True, False])
def test_binned_route_matches_jax_binned_kernel(draw_backside, latch_z):
    fv = _soup()
    attrs = np.random.RandomState(12).rand(2, 71, 4).astype(np.float32) if latch_z else None
    index, coords, attr_planes = resolve_gather_pallas(
        jnp.asarray(fv), None if attrs is None else jnp.asarray(attrs), 128,
        draw_backside=draw_backside, interpret=True, mode="binned", latch_z=latch_z,
    )
    got_index, fvm, got_attrs = resolve_and_gather(
        _planar(fv), 128, 0.1, 100.0, draw_backside,
        None if attrs is None else torch.tensor(attrs), latch_z, mode="binned",
    )
    np.testing.assert_array_equal(got_index.numpy(), np.asarray(index))
    planes = slice(None) if latch_z else [0, 1, 3, 4, 6, 7]
    np.testing.assert_array_equal(fvm[:, planes].numpy(), np.asarray(coords))
    if latch_z:
        np.testing.assert_array_equal(got_attrs.numpy(), np.asarray(attr_planes))
    assert (got_index.numpy() >= 0).mean() > 0.3


@pytest.mark.parametrize("draw_backside", [True, False])
def test_binned_index_map_window_matches_jax_binned_kernel(draw_backside):
    """The index map against the binned kernel; the depth against the eager
    XLA resolve of the same window: the interpret-mode kernel is compiled by
    XLA:CPU, which contracts zp's denominator into multiply-adds (ROADMAP
    P2), a few ulp."""
    fv = _soup()
    want_index = compute_face_index_map_pallas(
        jnp.asarray(fv), 128, draw_backside=draw_backside, interpret=True, mode="binned",
        row_start=64, num_rows=64,
    )
    with jax.disable_jit():
        _, want_depth = jres.compute_face_index_map(
            jnp.asarray(fv), 128, draw_backside=draw_backside, row_start=64, num_rows=64,
            return_depth=True)
    index, depth = compute_face_index_map(
        torch.tensor(fv), 128, draw_backside=draw_backside, row_start=64, num_rows=64,
        return_depth=True, mode="binned",
    )
    assert index.shape == (2, 64, 128)
    np.testing.assert_array_equal(index.numpy(), np.asarray(want_index))
    np.testing.assert_array_equal(depth.numpy(), np.asarray(want_depth))


@pytest.mark.parametrize("window", [(0, None), (30, 37)])
@pytest.mark.parametrize("mode", ["tiled", "binned"])
def test_index_map_at_size_100_matches_jax_xla(mode, window):
    """S = 100 is not a power of two: the XLA resolve, which divides as the
    port does (the depth against its eager run, ROADMAP P2)."""
    row_start, num_rows = window
    fv = _soup(4, 2, 61)
    want = jres.compute_face_index_map(jnp.asarray(fv), 100, row_start=row_start,
                                       num_rows=num_rows)
    with jax.disable_jit():
        _, want_depth = jres.compute_face_index_map(
            jnp.asarray(fv), 100, row_start=row_start, num_rows=num_rows, return_depth=True)
    index, depth = compute_face_index_map(torch.tensor(fv), 100, row_start=row_start,
                                               num_rows=num_rows, return_depth=True, mode=mode)
    np.testing.assert_array_equal(index.numpy(), np.asarray(want))
    np.testing.assert_array_equal(depth.numpy(), np.asarray(want_depth))
    assert (index.numpy() >= 0).any()


def test_weight_maps_with_row_windows_match_jax():
    fv = _soup(5, 2, 29)
    size, row_start, num_rows = 48, 10, 20
    fim = np.asarray(jres.compute_face_index_map(jnp.asarray(fv), size, row_start=row_start,
                                                 num_rows=num_rows))
    got_fim = compute_face_index_map(torch.tensor(fv), size, row_start=row_start,
                                          num_rows=num_rows)
    np.testing.assert_array_equal(got_fim.numpy(), fim)
    safe = np.maximum(fim, 0).reshape(2, -1, 1)
    fvm = np.take_along_axis(fv.reshape(2, -1, 9), safe, axis=1).reshape(2, num_rows, size, 3, 3)
    with jax.disable_jit():     # jitted XLA contracts the weight math into FMAs
        want = np.asarray(jres.compute_weight_map(jnp.asarray(fv), jnp.asarray(fim), size,
                                                  row_start))
        want_g = np.asarray(jres.weight_map_from_gathered(jnp.asarray(fvm), jnp.asarray(fim),
                                                          size, row_start))
    planar = np.ascontiguousarray(fvm.reshape(2, num_rows, size, 9).transpose(0, 3, 1, 2))
    want_p = np.asarray(jres.weight_planes_from_gathered(jnp.asarray(planar), jnp.asarray(fim),
                                                         size, row_start))
    t_fim = torch.tensor(fim)
    got = tres.compute_weight_map(torch.tensor(fv), t_fim, size, row_start)
    got_g = tres.weight_map_from_gathered(torch.tensor(fvm), t_fim, size, row_start)
    got_p = tres.weight_planes_from_gathered(torch.tensor(planar), t_fim, size, row_start)
    assert got.shape == (2, num_rows, size, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    assert (want > 0).any()


def _count_binned(monkeypatch):
    """Count the binned route's plain resolves (the CPU path has no launches)."""
    calls = []
    for name in ("resolve_binned_xy_plain", "resolve_binned_latch_plain"):
        fn = getattr(rc, name)
        monkeypatch.setattr(rc, name, lambda *a, fn=fn, name=name, **kw:
                            calls.append(name) or fn(*a, **kw))
    return calls


def test_forced_binned_silhouettes_match_eager_jax(monkeypatch):
    ndc, faces = _jax_scene()
    target = _silhouette_target(64)
    want_im, want_g = _jax_image_and_grads(ndc, faces, JaxHP(image_size=64), target)
    calls = _count_binned(monkeypatch)
    with rc.forced_route("binned"):
        got_im, got_g = _port_image_and_grads(ndc, faces, tnr.RasterizeHyperparam(image_size=64),
                                              target)
    assert calls == ["resolve_binned_xy_plain"]
    np.testing.assert_allclose(got_im, want_im, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-6 * np.abs(want_g).max())
    fv = np.take(ndc, faces, axis=1)
    got_fim = compute_face_index_map(torch.tensor(fv), 128, mode="binned")
    np.testing.assert_array_equal(got_fim.numpy(),
                                  np.asarray(jres.compute_face_index_map(jnp.asarray(fv), 128)))


def test_forced_binned_textured_lit_render_matches_eager_jax(monkeypatch):
    scene = _scene(16, 12, "texel2")
    target = _rgb_target("rgba", 64)
    want_im, want_g = _jax_render("rgba", scene, LIT, JaxHP(image_size=64), target)
    calls = _count_binned(monkeypatch)
    with rc.forced_route("binned"):
        got_im, got_g = _port_render("rgba", scene, LIT, tnr.RasterizeHyperparam(image_size=64),
                                     target)
    assert calls == ["resolve_binned_latch_plain"]
    np.testing.assert_allclose(got_im, want_im, rtol=0, atol=1e-6)
    _assert_grads(got_g, want_g)
    assert np.abs(want_g["light0_color"]).max() > 0


@pytest.mark.parametrize("entry", ["silhouettes", "rgba", "depth"])
def test_routes_are_bit_equal(entry):
    """The same render through each route: images, gradients and index maps
    equal bit for bit (the route changes time, nothing else)."""
    ndc, f, vt, ft, tex, ts = _scene(16, 12, "texel2")
    out = []
    for route in rc.ROUTES:
        with rc.forced_route(route):
            if entry == "silhouettes":
                im, g = _port_image_and_grads(ndc, f, tnr.RasterizeHyperparam(image_size=64),
                                              _silhouette_target(64))
                g = {"vertices": g}
            else:
                im, g = _port_render(entry, (ndc, f, vt, ft, tex, ts),
                                     LIT if entry == "rgba" else None,
                                     tnr.RasterizeHyperparam(image_size=64), None)
            fim = resolve_and_gather(torch.tensor(np.take(ndc, f, axis=1).transpose(0, 3, 2, 1)
                                                  .copy()), 128, 0.1, 100.0, True)[0]
        out.append((im, g, fim))
    (im_t, g_t, fim_t), (im_b, g_b, fim_b) = out
    np.testing.assert_array_equal(im_b, im_t)
    assert torch.equal(fim_b, fim_t)
    for k in g_t:
        np.testing.assert_array_equal(g_b[k], g_t[k], err_msg=k)
    assert np.abs(g_t["vertices"]).max() > 0


def test_route_rule_reads_shapes_only():
    # the seven configurations of chip_smoke.py (bs, rows, S, nf)
    tiled = [(1, 512, 512, 2560)]                        # bench, atlas, lit
    binned = [(1, 512, 512, 81920), (1, 512, 512, 158720),  # scale, textured-scale
              (1, 2048, 2048, 81920), (1, 1024, 1024, 158720)]  # hires, hires-lit
    assert all(rc.resolve_route(*s) == "tiled" for s in tiled)
    assert all(rc.resolve_route(*s) == "binned" for s in binned)
    # its threshold sweep at 512^2: tiled was faster up to 32,480 faces,
    # binned from 39,680 on
    assert [rc.resolve_route(1, 512, 512, nf)
            for nf in (9920, 19888, 26000, 32480, 39680, 50400, 62000)] \
        == ["tiled"] * 4 + ["binned"] * 3
    # K8's tile on the binned route: 8x8, measured faster than 16x16 at all
    # four, hires included
    assert rc.BIN_TILE == (8, 8)
    with rc.forced_route("binned"):
        assert rc.resolve_route(*tiled[0]) == "binned"
        assert rc.resolve_route(*binned[0], mode="tiled") == "tiled"
    assert rc._route["mode"] is None
    with pytest.raises(ValueError):
        rc.resolve_route(1, 8, 8, 1, mode="windowed")
    with pytest.raises(ValueError):
        with rc.forced_route("auto"):
            pass
