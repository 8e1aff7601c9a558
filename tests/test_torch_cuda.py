"""The port's hand-written CUDA kernels against their plain versions, and
the compiled core (``ops/graphs.py``: each ``rasterize_*`` call replays a
CUDA graph, on either resolve route) against the eager step, on the card.  Marked
``cuda``: each test skips without a CUDA device.  A test that counts one
step's launches runs it under ``nr.eager()``: a graph's kernels are counted
when it is captured, not at its replays.  This file imports no JAX, so it
also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import collections
import gc
import json
import weakref
from unittest.mock import patch as _patch

import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu_torch.benchmarks import bench, steps
from neural_renderer_v2_pytorch_tpu_torch.ops import graphs
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import (
    EDGE_SIZE,
    atlas_scene,
    edge_scenes,
    icosphere,
    lit_light_arrays,
    texel_scene,
    torus,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _soup_planar(seed, bs, nf, device):
    rng = np.random.RandomState(seed)
    fv = rng.uniform(-1, 1, (bs, nf, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    fv[:, 1] = fv[:, 0]                       # exact duplicate
    fv[:, 2, 1] = fv[:, 2, 0]                 # degenerate
    return torch.tensor(fv.transpose(0, 3, 2, 1).copy(), device=device)


@pytest.mark.parametrize("draw_backside", [True, False])
@pytest.mark.parametrize("bs,nf,size", [(2, 37, 64), (1, 300, 100), (3, 5, 17)])
def test_face_setup_and_resolve_are_bit_exact(cuda, bs, nf, size, draw_backside):
    """K1 and K2 (which forms K1's constants itself while staging faces)
    against their plain versions, and K2 against K7 + K8, on a soup with a
    duplicate, a degenerate face and backfacing ones."""
    fvp = _soup_planar(nf, bs, nf, cuda)
    consts = rc.face_setup(fvp, draw_backside)
    assert torch.equal(consts, rc.face_setup_plain(fvp, draw_backside))
    rc.reset_launches()
    got = rc.resolve_xy(fvp, draw_backside, size, 0.1, 100.0)
    assert rc.LAUNCHES["resolve_xy"] == 1 and rc.LAUNCHES["face_setup"] == 0
    want = rc.resolve_xy_plain(fvp, draw_backside, size, 0.1, 100.0)
    binned = rc.resolve_binned_xy(fvp, draw_backside, rc.bin_faces(fvp, draw_backside, size),
                                  size, 0.1, 100.0)
    assert rc.LAUNCHES["face_setup"] == 0
    for g, w, b in zip(got, want, binned):
        assert torch.equal(g, w) and torch.equal(g, b)
    assert (got[0] >= 0).any()


def test_scatters_match_plain_versions(cuda):
    _, faces = icosphere(3)
    nv, nf = int(faces.max()) + 1, len(faces)
    f = torch.tensor(faces, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    g9 = torch.randn((2, 3, 3, nf), generator=gen, device=cuda)
    got = rc.scatter_faces_to_vertices(g9, f, nv)
    want = rc.scatter_faces_to_vertices_plain(g9, f, nv)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))

    fim = torch.randint(-1, nf, (2, 64, 64), generator=gen, device=cuda, dtype=torch.int32)
    g6 = torch.randn((2, 6, 64, 64), generator=gen, device=cuda)
    got = rc.scatter_pixels_to_faces(g6, fim, nf)
    want = rc.scatter_pixels_to_faces_plain(g6, fim, nf)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def _winner_maps(bs, H, W, nf, seed):
    """name -> an index map i32 [bs, H, W] for K3: random ids with
    background; one face winning every pixel; a checkerboard of distinct
    winners on background; runs of a few faces; ids outside the table."""
    rng = np.random.RandomState(seed)
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    distinct = (i * W + j) % nf
    runs = (j // 5 + 3 * (i // 4)) % nf
    outside = rng.randint(0, nf, (bs, H, W))
    outside.reshape(-1)[::7] = -7
    outside.reshape(-1)[3::11] = nf
    outside.reshape(-1)[5::13] = nf + 5
    maps = {
        "random": rng.randint(-1, nf, (bs, H, W)),
        "one face": np.full((bs, H, W), nf // 2),
        "checkerboard": np.broadcast_to(np.where((i + j) % 2 == 0, distinct, -1), (bs, H, W)),
        "runs": np.broadcast_to(runs, (bs, H, W)),
        "outside": outside,
    }
    return {k: np.ascontiguousarray(v).astype(np.int32) for k, v in maps.items()}


@pytest.mark.parametrize("D", [6, 15, 27, 36])
@pytest.mark.parametrize("bs,H,W,nf", [(2, 64, 64, 700), (2, 1, 5000, 3000), (1, 100, 37, 90)])
def test_pixel_scatter_on_winner_maps(cuda, bs, H, W, nf, D):
    """K3 against its plain version within 1e-4 of the largest magnitude on
    every map of :func:`_winner_maps`, at the planes of the silhouette (6),
    atlas (15), textured-scale gather (27) and lit (36) paths, and on one
    row of P pixels (K9's transpose), where a block is a run of 256."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    g = torch.randn((bs, D, H, W), generator=gen, device=cuda)
    for name, fim in _winner_maps(bs, H, W, nf, D).items():
        f = torch.tensor(fim, device=cuda)
        got = rc.scatter_pixels_to_faces(g, f, nf)
        want = rc.scatter_pixels_to_faces_plain(g, f, nf)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()),
                                   msg=name)


def test_pixel_scatter_is_two_device_operations(cuda):
    """One K3 call is the output's zero fill and the kernel, within 1e-4 of
    the plain version."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    nf = 2560
    fim = torch.tensor(_winner_maps(1, 512, 512, nf, 1)["runs"], device=cuda)
    g = torch.randn((1, 6, 512, 512), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    want = rc.scatter_pixels_to_faces_plain(g, fim, nf)
    rc.scatter_pixels_to_faces(g, fim, nf)
    torch.cuda.synchronize()
    rc.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            got = rc.scatter_pixels_to_faces(g, fim, nf)
        torch.cuda.synchronize()
    assert rc.LAUNCHES["scatter_pixels_to_faces"] == 4
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    # the profiler may drop a record, never add one
    records = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    assert sum(records.values()) <= 8, records
    assert all("Memset" in k or "scatter_pixels_to_faces_kernel" in k for k in records), records


@pytest.mark.parametrize("draw_backside", [True, False])
def test_tiled_forms_from_face_vertices_on_killed_faces(cuda, draw_backside):
    """K2, K2L and K2D from the face vertices, on faces the kill rule drops
    (degenerate, NaN, backfacing) beside live ones, a NaN depth and a face
    wholly off the canvas: bit-equal to K1's plain version + the plain
    fold, and to K7 + K8; no K1 launched."""
    bs, nf, size = 2, 96, 48
    fvp = _soup_planar(33, bs, nf, cuda)
    fvp[:, :2, :, 10] = float("nan")           # NaN screen coordinates
    fvp[:, 0, 1, 11] = float("nan")
    fvp[:, 2, 0, 12] = float("nan")            # a NaN depth: zp NaN, rejected
    fvp[:, :2, :, 13] += 5.0                   # off the canvas
    fvp[:, :, 1, 14] = fvp[:, :, 0, 14]        # two vertices in one: zero area
    attrs = torch.randn((bs, nf, 5), generator=torch.Generator(device=cuda).manual_seed(3),
                        device=cuda)
    consts = rc.face_setup_plain(fvp, draw_backside)
    args = (size, 0.1, 100.0)
    rc.reset_launches()
    bins = rc.bin_faces(fvp, draw_backside, size)
    tiled = [rc.resolve_xy(fvp, draw_backside, *args),
             rc.resolve_latch(fvp, attrs, draw_backside, *args),
             rc.resolve_depth(fvp, draw_backside, *args)]
    assert rc.LAUNCHES["face_setup"] == 0
    plain = [rc.resolve_xy_plain(fvp, draw_backside, *args),
             rc.resolve_latch_plain(fvp, attrs, draw_backside, *args),
             rc.resolve_depth_plain(fvp, draw_backside, *args)]
    binned = [rc.resolve_binned_xy(fvp, draw_backside, bins, *args),
              rc.resolve_binned_latch(fvp, attrs, draw_backside, bins, *args),
              rc.resolve_binned_depth(fvp, draw_backside, bins, *args)]
    assert rc.LAUNCHES["face_setup"] == 0
    for t, p, b in zip(tiled, plain, binned):
        for x, y, z in zip(t, p, b):
            assert torch.equal(x, y) and torch.equal(x, z)
    killed = (consts[:, 13] == 4.0) & (consts[:, 14] == -4.0)
    assert killed[:, [10, 11, 14]].all() and (tiled[0][0] >= 0).any()


def test_slice_on_card_matches_cpu(cuda):
    """Same NDC vertices on the card and the CPU: images equal, gradients
    within the atomics' bound, and every kernel launched."""
    v, f = torus(16, 12)
    r = nr.Renderer("cpu")
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 20)
    ndc = r.transform_vertices(torch.tensor(v[None])).detach()
    out = []
    rc.reset_launches()
    for dev in ("cpu", cuda):
        x = ndc.detach().to(dev).requires_grad_(True)
        with nr.eager():                 # one step's launches, counted as they run
            im = nr.rasterize_silhouettes(x, torch.tensor(f, device=dev), None,
                                          nr.RasterizeHyperparam(image_size=64))
            torch.sum(im * im).backward()
        out.append((im.detach().cpu(), x.grad.cpu()))
    # the tiled route: K2 forms the face constants itself, so no K1; the
    # NMR passes K10, K11 and K12 once each
    silhouette = ("resolve_xy", "scatter_pixels_to_faces", "scatter_faces_to_vertices",
                  "gather_faces3", "nmr_planes", "nmr_planes_vjp", "nmr_coordinate_grad")
    assert all(rc.LAUNCHES[n] == (1 if n in silhouette else 0) for n in rc.KERNELS), rc.LAUNCHES
    renderer = nr.Renderer("cuda")                  # no index: the current card
    renderer.render_silhouettes(torch.tensor(v[None], device=cuda), f)
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[1][1], out[0][1], rtol=0,
                               atol=1e-4 * float(out[0][1].abs().max()))


def test_wrappers_reject_bad_inputs(cuda):
    fvp = _soup_planar(0, 1, 8, cuda)
    with pytest.raises(ValueError):
        rc.face_setup(fvp.double(), True)
    with pytest.raises(ValueError):
        rc.face_setup(fvp.transpose(1, 2), True)
    with pytest.raises(ValueError):
        rc.resolve_xy(fvp.transpose(1, 2), True, 16, 0.1, 100.0)
    with pytest.raises(ValueError):
        rc.resolve_latch(fvp, torch.ones((1, 8, 3)), True, 16, 0.1, 100.0)
    with pytest.raises(ValueError):
        rc.scatter_pixels_to_faces(torch.ones((1, 6, 4, 4), device=cuda),
                                   torch.zeros((1, 4, 4), dtype=torch.int64, device=cuda), 8)


@pytest.mark.parametrize("num_attrs", [0, 6, 27])
@pytest.mark.parametrize("bs,nf,size", [(2, 37, 64), (1, 300, 100)])
def test_resolve_latch_is_bit_exact(cuda, bs, nf, size, num_attrs):
    fvp = _soup_planar(nf + 1, bs, nf, cuda)
    attrs = torch.randn((bs, nf, num_attrs), device=cuda)
    got = rc.resolve_latch(fvp, attrs, True, size, 0.1, 100.0)
    want = rc.resolve_latch_plain(fvp, attrs, True, size, 0.1, 100.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # its index and depth are K2's
    xy = rc.resolve_xy(fvp, True, size, 0.1, 100.0)
    assert torch.equal(got[0], xy[0]) and torch.equal(got[1], xy[1])
    assert torch.equal(got[2][:, [0, 1, 3, 4, 6, 7]], xy[2])


def test_gather_and_row_scatter_match_plain_versions(cuda):
    v, faces = icosphere(3)
    f = torch.tensor(faces, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for D in (3, 12):
        table = torch.randn((2, len(v), D), generator=gen, device=cuda)
        assert torch.equal(rc.gather_faces3(table, f), rc.gather_faces3_plain(table, f))
    # K6 on random anchors (-1, and past T - tw - 2 and T), at atlas's
    # shapes (a 1190 x 1920 atlas, 512^2 pixels) and on an odd atlas width
    # and texel count (float2 pairs unaligned in every other plane)
    P = 512 * 512
    g = torch.randn((2, 12, P), generator=gen, device=cuda)
    for th, tw in ((1190, 1920), (23, 37)):
        T = th * tw
        ids = torch.randint(-1, T + 4, (2, P), generator=gen, device=cuda, dtype=torch.int32)
        got, want = rc.atlas_taps_grad(g, ids, tw, T), rc.atlas_taps_grad_plain(g, ids, tw, T)
        assert got.shape == (2, 3, T) and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("scene", ["atlas", "lit"])
def test_textured_slice_on_card_matches_cpu(cuda, scene):
    """The same NDC inputs on the card and the CPU: images within 1e-5
    (CUDA's pow and division), gradients within the atomics' bound, and the
    textured path's kernels launched."""
    if scene == "atlas":
        v, f, vt, ft, tex = atlas_scene(16, 12, 40, 64)
        lights, ts = None, None
    else:
        v, f, vt, ft, tex = texel_scene(16, 12, 2)
        lights, ts = lit_light_arrays(), 2
    r = nr.Renderer("cpu")
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 20)
    ndc = r.transform_vertices(torch.tensor(v[None])).detach()
    out = []
    rc.reset_launches()
    for dev in ("cpu", cuda):
        x = ndc.detach().to(dev).requires_grad_(True)
        t = torch.tensor(tex, device=dev, requires_grad=True)
        cls = {"ambient": nr.AmbientLight, "directional": nr.DirectionalLight,
               "specular": nr.SpecularLight}
        ls = None if lights is None else tuple(
            cls[k](**{n: torch.tensor(a, device=dev) for n, a in arrays.items()})
            for k, arrays in lights)
        p = nr.RasterizeParam(vertices_textures=torch.tensor(vt, device=dev),
                              faces_textures=torch.tensor(ft, device=dev), textures=t,
                              texture_size=ts, lights=ls)
        with nr.eager():                 # one step's launches, counted as they run
            im = nr.rasterize_rgba(x, torch.tensor(f, device=dev), p,
                                   nr.RasterizeHyperparam(image_size=64))
            torch.sum(im * im).backward()
        out.append((im.detach().cpu(), x.grad.cpu(), t.grad.cpu()))
    textured = ("resolve_latch", "scatter_pixels_to_faces", "scatter_faces_to_vertices",
                "gather_faces3")
    assert all(rc.LAUNCHES[n] == 1 for n in textured), rc.LAUNCHES
    assert rc.LAUNCHES["face_setup"] == 0 and rc.LAUNCHES["bin_faces"] == 0, rc.LAUNCHES
    # the loaded atlas's sampler is K13 and K14, which adds the taps as K6
    # does; K6 itself runs on no render path
    atlas = 1 if scene == "atlas" else 0
    assert [rc.LAUNCHES[n] for n in ("atlas_sample", "atlas_sample_vjp")] == [atlas, atlas]
    assert rc.LAUNCHES["atlas_taps_grad"] == 0
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=1e-5)
    for i in (1, 2):
        torch.testing.assert_close(out[1][i], out[0][i], rtol=0,
                                   atol=1e-4 * float(out[0][i].abs().max()))


@pytest.mark.parametrize("window", [(0, None), (40, 27)])
@pytest.mark.parametrize("bs,nf,size", [(2, 37, 64), (1, 300, 100), (3, 5, 17)])
def test_bin_faces_and_binned_resolve_are_bit_exact(cuda, bs, nf, size, window):
    """K7's bins against their plain version, and each K8 form against its
    plain version and the tiled form, on ragged canvases and windows."""
    row_start, num_rows = window
    if num_rows is not None and row_start + num_rows > size:
        row_start, num_rows = size // 3, size // 2
    fvp = _soup_planar(nf + 2, bs, nf, cuda)
    attrs = torch.randn((bs, nf, 6), device=cuda)
    w = (row_start, num_rows)
    bins = rc.bin_faces(fvp, True, size, *w)
    for g, p in zip(bins, rc.bin_faces_plain(fvp, True, size, *w)):
        assert torch.equal(g, p)
    args = (size, 0.1, 100.0, *w)
    forms = [
        (rc.resolve_binned_xy(fvp, True, bins, *args),
         rc.resolve_binned_xy_plain(fvp, True, bins, *args),
         rc.resolve_xy(fvp, True, *args)),
        (rc.resolve_binned_latch(fvp, attrs, True, bins, *args),
         rc.resolve_binned_latch_plain(fvp, attrs, True, bins, *args),
         rc.resolve_latch(fvp, attrs, True, *args)),
        (rc.resolve_binned_depth(fvp, True, bins, *args),
         rc.resolve_binned_depth_plain(fvp, True, bins, *args),
         rc.resolve_depth(fvp, True, *args)),
    ]
    for got, plain, tiled in forms:
        for g, p, t in zip(got, plain, tiled):
            assert torch.equal(g, p) and torch.equal(g, t)
    assert (forms[0][0][0] >= 0).any()


@pytest.mark.parametrize("window", [(0, None), (40, 27)])
@pytest.mark.parametrize("bs,nf,size", [(2, 37, 64), (1, 300, 100), (3, 5, 17)])
def test_capped_bins_and_overflow_bins_are_bit_exact(cuda, bs, nf, size, window):
    """K7's capped form against its plain version at capacities 0, just
    under the pair total and the total (flags, counts, the overflow word
    and the bins that fit), and each K8 form over the capped bins, whose
    overflow bins take every face, bit-equal to the exact bins'."""
    row_start, num_rows = window
    if num_rows is not None and row_start + num_rows > size:
        row_start, num_rows = size // 3, size // 2
    fvp = _soup_planar(nf + 2, bs, nf, cuda)
    attrs = torch.randn((bs, nf, 6), device=cuda)
    w = (row_start, num_rows)
    exact = rc.bin_faces(fvp, True, size, *w)
    total = exact[2].shape[0]
    args = (size, 0.1, 100.0, *w)
    want = [rc.resolve_binned_xy(fvp, True, exact, *args),
            rc.resolve_binned_latch(fvp, attrs, True, exact, *args),
            rc.resolve_binned_depth(fvp, True, exact, *args)]
    assert total > 0
    for capacity in (0, total - 1, total):
        cnt, offsets, ids, overflow = rc.bin_faces(fvp, True, size, *w, capacity=capacity)
        p_cnt, p_offsets, p_ids, p_overflow = rc.bin_faces_plain(fvp, True, size, *w,
                                                                 capacity=capacity)
        assert torch.equal(cnt, p_cnt) and torch.equal(offsets, p_offsets)
        assert torch.equal(overflow, p_overflow) and ids.shape == (capacity,)
        fit = int(p_cnt[p_offsets >= 0].sum())
        assert torch.equal(ids[:fit], p_ids[:fit])
        assert (int(overflow) > 0) == (capacity < total)
        bins = (cnt, offsets, ids)
        got = [rc.resolve_binned_xy(fvp, True, bins, *args),
               rc.resolve_binned_latch(fvp, attrs, True, bins, *args),
               rc.resolve_binned_depth(fvp, True, bins, *args)]
        for g, wt in zip(got, want):
            for a, b in zip(g, wt):
                assert torch.equal(a, b)


def test_compute_face_index_map_on_card_launches_kernels(cuda):
    """The id/depth entry runs the route's resolve kernel on the card (K2D
    alone, or K7 and K8; K1 on neither), never the plain fold, and gives
    the CPU's result."""
    rng = np.random.RandomState(5)
    fv = rng.uniform(-1, 1, (2, 40, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    want = nr.compute_face_index_map(torch.tensor(fv), 64, return_depth=True)
    for mode, kernel, k7 in (("auto", "resolve_depth", 0), ("binned", "resolve_binned_depth", 1)):
        rc.reset_launches()
        got = nr.compute_face_index_map(torch.tensor(fv, device=cuda), 64, return_depth=True,
                                        mode=mode)
        assert rc.LAUNCHES["face_setup"] == 0 and rc.LAUNCHES[kernel] == 1, rc.LAUNCHES
        assert rc.LAUNCHES["bin_faces"] == k7, rc.LAUNCHES
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("D,n,P", [(3, 97, 301), (9, 517, 1000), (27, 130, 777)])
def test_gather_rows_is_bit_exact(cuda, D, n, P, planar):
    """K9 against its plain version in both layouts, with -1 ids (0 out),
    per-image ids and ids shared by the batch (a batch stride of 0)."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    table = torch.randn((2, n, D), generator=gen, device=cuda)
    ids = torch.randint(-1, n, (2, P), generator=gen, device=cuda, dtype=torch.int32)
    rc.reset_launches()
    for i in (ids, ids[:1].expand(2, -1)):
        got = rc.gather_rows(table, i, planar)
        assert got.shape == ((2, D, P) if planar else (2, P, D))
        assert torch.equal(got, rc.gather_rows_plain(table, i, planar))
    assert rc.LAUNCHES["gather_rows"] == 2
    with pytest.raises(ValueError):
        rc.gather_rows(table, ids.long(), planar)


@pytest.mark.parametrize("level", [3, 6])
@pytest.mark.parametrize("bs", [1, 2])
def test_vertex_sum_is_the_cpu_plain_versions_bits(cuda, bs, level):
    """K4 over its vertex -> slot table: the plain version's bits on CPU
    copies (its index_add_ there sums each vertex in slot order), at
    icosphere(3) and at 81,920 faces."""
    _, faces = icosphere(level)
    nv, nf = int(faces.max()) + 1, len(faces)
    f = torch.tensor(faces, device=cuda)
    g = torch.randn((bs, 3, 3, nf), generator=torch.Generator(device=cuda).manual_seed(level),
                    device=cuda)
    got = rc.scatter_faces_to_vertices(g, f, nv)
    assert torch.equal(got.cpu(), rc.scatter_faces_to_vertices_plain(g.cpu(), f.cpu(), nv))


def test_vertex_sum_repeats_its_bits_in_one_device_operation(cuda):
    """Two K4 calls give the same bits, and each is one device operation:
    the kernel, with no fill of its output."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, faces = icosphere(4)
    nv, nf = int(faces.max()) + 1, len(faces)
    f = torch.tensor(faces, device=cuda)
    g = torch.randn((2, 3, 3, nf), generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda)
    first = rc.scatter_faces_to_vertices(g, f, nv)          # builds the table
    torch.cuda.synchronize()
    rc.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            again = rc.scatter_faces_to_vertices(g, f, nv)
        torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert rc.LAUNCHES["scatter_faces_to_vertices"] == 4 and rc.SLOT_TABLE_BUILDS == 0
    # the profiler may drop a record, never add one: the kernel's name only
    device_ops = [(e.key, e.count) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    assert len(device_ops) == 1 and "scatter_faces_to_vertices_kernel" in device_ops[0][0]
    assert 1 <= device_ops[0][1] <= 4, device_ops


@pytest.mark.parametrize("D", [2, 3, 9])
@pytest.mark.parametrize("bs", [1, 8])
def test_face_vertex_gather_is_bit_exact(cuda, bs, D):
    """K5 (one thread per face and image; D = 3 unrolled, other D in a
    loop) against its plain version, and an id past the table (0 out)."""
    v, faces = icosphere(3)
    faces = faces.copy()
    f = torch.tensor(faces, device=cuda)
    table = torch.randn((bs, len(v), D), generator=torch.Generator(device=cuda).manual_seed(D),
                        device=cuda)
    rc.reset_launches()
    got = rc.gather_faces3(table, f)
    assert rc.LAUNCHES["gather_faces3"] == 1 and got.shape == (bs, D, 3, len(faces))
    assert torch.equal(got, rc.gather_faces3_plain(table, f))
    faces[-1, 2] = len(v)
    got = rc.gather_faces3(table, torch.tensor(faces, device=cuda))
    assert (got[:, :, 2, -1] == 0).all()
    assert torch.equal(got[..., :-1], rc.gather_faces3_plain(table, f)[..., :-1])


def test_gather_faces3_is_gather_rows_planar_form(cuda):
    """K5 is K9's planar form over the face slots k * nf + f, with the
    vertex ids shared by the batch: the same bits from either wrapper."""
    v, faces = icosphere(3)
    f = torch.tensor(faces, device=cuda)
    table = torch.randn((2, len(v), 3), generator=torch.Generator(device=cuda).manual_seed(3),
                        device=cuda)
    slots = f.t().reshape(1, -1).expand(2, -1)
    want = rc.gather_rows(table, slots, planar=True).reshape(2, 3, 3, len(faces))
    assert torch.equal(rc.gather_faces3(table, f), want)


def test_to_map_and_winner_planes_launch_k9_and_k3(cuda):
    """The public to_map (row layout) and the face-sharded path's winner
    planes (planar) launch K9 forward and K3 backward on the card: values
    equal to the CPU's, gradients within the atomics' bound."""
    from neural_renderer_v2_pytorch_tpu_torch.ops.gather_resolve import gather_winner_planes

    rng = np.random.RandomState(11)
    data = rng.randn(2, 45, 27).astype(np.float32)
    index = rng.randint(-1, 45, (2, 12, 20)).astype(np.int32)
    ct = rng.randn(2, 12, 20, 27).astype(np.float32)
    for fn, cot in ((nr.to_map, ct), (gather_winner_planes, ct.transpose(0, 3, 1, 2))):
        out = []
        for dev in ("cpu", cuda):
            rc.reset_launches()
            x = torch.tensor(data, device=dev, requires_grad=True)
            y = fn(x, torch.tensor(index, device=dev))
            y.backward(torch.tensor(np.ascontiguousarray(cot), device=dev))
            out.append((y.detach().cpu(), x.grad.cpu()))
        assert rc.LAUNCHES["gather_rows"] == 1 and rc.LAUNCHES["scatter_pixels_to_faces"] == 1
        assert torch.equal(out[1][0], out[0][0])
        torch.testing.assert_close(out[1][1], out[0][1], rtol=0,
                                   atol=1e-4 * float(out[0][1].abs().max()))


@pytest.mark.parametrize("mode", ["tiled", "binned"])
def test_index_map_window_past_the_image_bottom(cuda, mode):
    """An uneven tile split's last band runs past the image bottom: those
    rows resolve to background on both routes, as on the CPU."""
    rng = np.random.RandomState(6)
    fv = rng.uniform(-1, 1, (1, 60, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    window = dict(row_start=51, num_rows=17, return_depth=True)      # 66 rows of 64
    want = nr.compute_face_index_map(torch.tensor(fv), 64, **window)
    got = nr.compute_face_index_map(torch.tensor(fv, device=cuda), 64, mode=mode, **window)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert (want[0][:, 13:] == -1).all() and (want[0][:, :13] >= 0).any()


def _sharded_silhouettes(ndc, faces):
    """One rank of a (1, 1, 2) mesh on the card: the sharded silhouettes,
    the vertex gradient and the launch counts of the step."""
    from neural_renderer_v2_pytorch_tpu_torch import parallel

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.tensor(ndc, device=dev, requires_grad=True)
    rc.reset_launches()
    im = parallel.rasterize_silhouettes_sharded(
        x, torch.tensor(faces, device=dev), None, nr.RasterizeHyperparam(image_size=64),
        mesh=parallel.make_mesh(1, 1, 2))
    torch.sum(im * im).backward()
    torch.cuda.synchronize()
    return im.detach().cpu().numpy(), x.grad.cpu().numpy(), dict(rc.LAUNCHES)


def test_face_sharded_ranks_on_one_card_match_one_device(cuda):
    """Two gloo ranks share the card over a face axis of 2: each returns
    the single-device images, the single-device gradient within the
    atomics' bound and the other rank's gradient to the bit, and its step
    ran the id/depth resolve and K9."""
    from neural_renderer_v2_pytorch_tpu_torch import parallel

    v, f = torus(16, 12)
    r = nr.Renderer("cpu")
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 20)
    ndc = r.transform_vertices(torch.tensor(v[None])).detach().numpy()
    x = torch.tensor(ndc, device=cuda, requires_grad=True)
    im = nr.rasterize_silhouettes(x, torch.tensor(f, device=cuda), None,
                                  nr.RasterizeHyperparam(image_size=64))
    torch.sum(im * im).backward()
    ranks = parallel.run_ranks(_sharded_silhouettes, 2, (ndc, f), device="cuda",
                               backend="gloo", timeout=120.0)
    for image, grad, launches in ranks:
        assert np.array_equal(image, im.detach().cpu().numpy())
        want = x.grad.cpu().numpy()
        np.testing.assert_allclose(grad, want, rtol=0, atol=1e-4 * np.abs(want).max())
        assert launches["gather_rows"] == 1 and launches["resolve_depth"] == 1, launches
        assert launches["resolve_xy"] == 0 and launches["resolve_latch"] == 0, launches
        assert np.array_equal(grad, ranks[0][1])


def test_kernels_read_zero_and_add_nothing_for_ids_outside_the_table(cuda):
    """K5 and K9 (both layouts) read 0 and K4 adds nothing for ids of -1, n
    and n + 5, equal to their plain versions (K4 on CPU copies), which the
    CPU tier holds to the JAX package's one-hot kernels."""
    v, faces = icosphere(2)
    n, nf = len(v), len(faces)
    faces = faces.copy()
    faces[:3, 0], faces[3, 1], faces[4, 2] = (-1, n, n + 5), n, -1
    f = torch.tensor(faces, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    table = torch.randn((2, n, 3), generator=gen, device=cuda)
    got = rc.gather_faces3(table, f)
    assert torch.equal(got, rc.gather_faces3_plain(table, f))
    assert (got[:, :, 0, :3] == 0).all() and (got[:, :, 1, 3] == 0).all()
    ids = torch.randint(0, n, (2, 500), generator=gen, device=cuda, dtype=torch.int32)
    ids[:, :3] = torch.tensor([-1, n, n + 5], device=cuda, dtype=torch.int32)
    for planar in (True, False):
        got = rc.gather_rows(table, ids, planar)
        assert torch.equal(got, rc.gather_rows_plain(table, ids, planar))
        assert ((got[:, :, :3] if planar else got[:, :3]) == 0).all()
    g = torch.randn((2, 3, 3, nf), generator=gen, device=cuda)
    got = rc.scatter_faces_to_vertices(g, f, n)
    assert torch.equal(got.cpu(), rc.scatter_faces_to_vertices_plain(g.cpu(), f.cpu(), n))


def _bins_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("window", [(0, None), (56, 16)])
@pytest.mark.parametrize("mesh", ["icosphere(3)", "torus(320, 248)"])
def test_bin_faces_on_a_crowded_tile(cuda, mesh, window):
    """Every face K1 keeps in one bin, ordered through the block's bitmap:
    icosphere(3) (1,280 faces) in a 3-pixel disc of a 128^2 canvas, one
    window; textured-scale's torus (158,720 faces, about 74K kept) in a
    6-pixel disc of a 512^2 canvas, ids spanning more than one window of
    131,072, so two.  The plain version's bins either way, twice."""
    from test_torch_bin_faces import _crowded

    if mesh == "torus(320, 248)":
        # seen from above (its axis is y)
        v, f = torus(320, 248)
        v = v / np.abs(v).max()
        size, c, r = 512, (2.0 * 59.5 + 1.0 - 512) / 512, 2.0 * 3.0 / 512
        fv = np.stack([c + r * v[:, 0], c + r * v[:, 2], 2.0 + v[:, 1]], -1)
        fv = fv.astype(np.float32)[f][None]
    else:
        size = 128
        fv = _crowded(size, (59.5, 59.5), 1.5)
    fvp = torch.tensor(np.ascontiguousarray(fv.transpose(0, 3, 2, 1)), device=cuda)
    want = rc.bin_faces_plain(fvp, True, size, *window)
    k = int(want[0].argmax())
    top = want[2][int(want[1].reshape(-1)[k]):][:int(want[0].reshape(-1)[k])]
    assert len(top) > 1200
    if mesh == "torus(320, 248)":
        assert len(top) > 50_000 and int(top.max() - top.min()) >= 32 * 4096
    _bins_equal(rc.bin_faces(fvp, True, size, *window), want)
    _bins_equal(rc.bin_faces(fvp, True, size, *window), want)


def test_bin_faces_at_scale_repeats_its_bits_in_four_device_operations(cuda):
    """K7 at scale's shapes (icosphere(6), 512^2): the plain version's bins,
    the same bits on a second call, and per call at most four device
    operations (the memset and the three kernels) and one readback."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    v, faces = icosphere(6)
    r = nr.Renderer(cuda)
    r.image_size, r.anti_aliasing = 512, False
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 30.0)
    ndc = r.transform_vertices(torch.tensor(v[None], device=cuda))
    fvp = rc.gather_faces3(ndc.contiguous(), torch.tensor(faces, device=cuda))
    first = rc.bin_faces(fvp, True, 512)
    _bins_equal(first, rc.bin_faces_plain(fvp, True, 512))
    torch.cuda.synchronize()
    rc.reset_launches()
    calls = 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            again = rc.bin_faces(fvp, True, 512)
        torch.cuda.synchronize()
    _bins_equal(again, first)
    assert rc.LAUNCHES["bin_faces"] == calls
    # the profiler may drop a record, never add one
    records = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    readback = {k: n for k, n in records.items() if "Memcpy DtoH" in k}
    ops = {k: n for k, n in records.items() if k not in readback}
    assert sum(readback.values()) <= calls and sum(ops.values()) <= 4 * calls, records
    kernels = ("bin_count_kernel", "bin_fill_kernel", "bin_order_kernel")
    assert all(any(n in k for n in kernels) or "Memset" in k for k in ops), records


@pytest.mark.parametrize("window", [(0, None), (30, 41)])
@pytest.mark.parametrize("bs,nf", [(2, 37), (1, 257), (2, 2561), (1, 0)])
def test_tiled_forms_on_ragged_shapes_match_plain_and_binned(cuda, bs, nf, window):
    """K2, K2L and K2D bit-equal to their plain versions and to K7 + K8 at
    S = 100 (a ragged last tile), on nf % 4 != 0 (every face row of fvp
    unaligned but the first), nf under one batch, several batches and nf =
    0, on the canvas and a row window, with and without backfaces."""
    S = 100
    fvp = _soup_planar(nf + 7, bs, max(nf, 3), cuda)[..., :nf].contiguous()
    attrs = torch.randn((bs, nf, 4), generator=torch.Generator(device=cuda).manual_seed(nf),
                        device=cuda)
    for backside in (True, False):
        args = (S, 0.1, 100.0, *window)
        bins = rc.bin_faces(fvp, backside, S, *window)
        forms = {
            "resolve_xy": (rc.resolve_xy(fvp, backside, *args),
                           rc.resolve_xy_plain(fvp, backside, *args),
                           rc.resolve_binned_xy(fvp, backside, bins, *args)),
            "resolve_latch": (rc.resolve_latch(fvp, attrs, backside, *args),
                              rc.resolve_latch_plain(fvp, attrs, backside, *args),
                              rc.resolve_binned_latch(fvp, attrs, backside, bins, *args)),
            "resolve_depth": (rc.resolve_depth(fvp, backside, *args),
                              rc.resolve_depth_plain(fvp, backside, *args),
                              rc.resolve_binned_depth(fvp, backside, bins, *args)),
        }
        for form, (got, plain, binned) in forms.items():
            for g, p, b in zip(got, plain, binned):
                assert torch.equal(g, p) and torch.equal(g, b), (form, backside)
        index = forms["resolve_depth"][0][0]
        assert (index >= 0).any() if nf else (index == -1).all()


@pytest.mark.parametrize("mesh", ["icosphere(3)", "torus(320, 248)"])
def test_binned_resolve_on_a_crowded_tile(cuda, mesh):
    """K8 over one bin that holds every live face (its CTA stages it 64
    entries at a time: ~20 batches for icosphere(3), ~1,150 for
    textured-scale's torus) bit-equal to the tiled forms, and, for the
    small mesh, to its plain version."""
    from test_torch_bin_faces import _crowded

    if mesh == "torus(320, 248)":
        v, f = torus(320, 248)
        v = v / np.abs(v).max()
        size, c, r = 512, (2.0 * 59.5 + 1.0 - 512) / 512, 2.0 * 3.0 / 512
        fv = np.stack([c + r * v[:, 0], c + r * v[:, 2], 2.0 + v[:, 1]], -1)
        fv = fv.astype(np.float32)[f][None]
    else:
        size = 128
        fv = _crowded(size, (59.5, 59.5), 1.5)
    fvp = torch.tensor(np.ascontiguousarray(fv.transpose(0, 3, 2, 1)), device=cuda)
    attrs = torch.randn((1, fvp.shape[-1], 3), device=cuda)
    bins = rc.bin_faces(fvp, True, size)
    args = (size, 0.1, 100.0)
    forms = [(rc.resolve_binned_xy(fvp, True, bins, *args), rc.resolve_xy(fvp, True, *args)),
             (rc.resolve_binned_latch(fvp, attrs, True, bins, *args),
              rc.resolve_latch(fvp, attrs, True, *args)),
             (rc.resolve_binned_depth(fvp, True, bins, *args), rc.resolve_depth(fvp, True, *args))]
    for got, tiled in forms:
        for g, t in zip(got, tiled):
            assert torch.equal(g, t)
    assert int(bins[0].max()) > 1200 and (forms[0][0][0] >= 0).any()
    if mesh == "icosphere(3)":
        plain = [rc.resolve_binned_xy_plain(fvp, True, bins, *args),
                 rc.resolve_binned_latch_plain(fvp, attrs, True, bins, *args),
                 rc.resolve_binned_depth_plain(fvp, True, bins, *args)]
        for (got, _), want in zip(forms, plain):
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def test_binned_step_launches_no_k1(cuda):
    """A silhouette step and an RGB step forced down the binned route launch
    K7 and K8 and no K1, and give the tiled route's images."""
    v, f = torus(40, 32)
    r = nr.Renderer(cuda)
    r.image_size = 64
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
    x = torch.tensor(v[None], device=cuda)
    faces = torch.tensor(f, device=cuda)
    want = r.render_silhouettes(x, faces)
    depth_want = r.render_depth(x, faces)
    rc.reset_launches()
    with rc.forced_route("binned"), nr.eager():
        xx = x.clone().requires_grad_(True)
        images = r.render_silhouettes(xx, faces)
        images.sum().backward()
        depth = r.render_depth(x, faces)
    assert torch.equal(images.detach(), want) and torch.equal(depth, depth_want)
    assert rc.LAUNCHES["face_setup"] == 0, rc.LAUNCHES
    assert rc.LAUNCHES["bin_faces"] == 2 and rc.LAUNCHES["resolve_binned_xy"] == 1
    assert rc.LAUNCHES["resolve_binned_latch"] == 1, rc.LAUNCHES


def test_user_surface_on_the_card(cuda, tmp_path):
    """``load_obj`` and ``Mesh`` default to the card with int32 faces;
    ``Adam`` on the card matches it on the CPU; ``camera_mode="look"``
    renders the same images through the kernels as through their plain
    versions, and a fit over one faces tensor builds one K4 table."""
    v, f = torus(16, 12)
    path = tmp_path / "torus.obj"
    with open(path, "w") as fh:
        fh.writelines("v %.8f %.8f %.8f\n" % tuple(p) for p in v)
        fh.writelines("f %d %d %d\n" % tuple(t + 1) for t in f)
    vertices, faces = nr.load_obj(str(path))
    assert vertices.is_cuda and faces.is_cuda and faces.dtype == torch.int32
    mesh = nr.Mesh(str(path))
    assert mesh.vertices.is_cuda and mesh.faces.dtype == torch.int32

    grads = torch.randn((5,) + vertices.shape, generator=torch.Generator().manual_seed(0))
    params = {d: vertices.detach().to(d).clone().requires_grad_(True) for d in ("cpu", cuda)}
    opts = {d: nr.Adam([p], lr=0.01) for d, p in params.items()}
    for g in grads:
        for d, p in params.items():
            p.grad = g.to(d)
            opts[d].step()
    torch.testing.assert_close(params[cuda].detach().cpu(), params["cpu"].detach(),
                               rtol=1e-6, atol=1e-7)

    r = nr.Renderer(cuda)
    r.image_size = 64
    r.camera_mode = "look"
    r.viewpoints = (0.4, 0.9, -2.6)
    r.camera_direction = torch.tensor([-0.15, -0.3, 1.0], device=cuda)
    images = r.render_silhouettes(vertices[None], faces)
    with rc.plain_versions():
        assert torch.equal(images, r.render_silhouettes(vertices[None], faces))
    assert 0.05 < float(images.mean()) < 0.5

    rc.reset_launches()
    x = vertices.clone()[None].requires_grad_(True)
    opt = nr.Adam([x], lr=0.01)
    with nr.eager():                     # three steps' launches, counted as they run
        for _ in range(3):
            opt.zero_grad()
            torch.sum((r.render_silhouettes(x, faces) - images.flip(2)) ** 2).backward()
            opt.step()
    assert rc.SLOT_TABLE_BUILDS == 1 and rc.LAUNCHES["scatter_faces_to_vertices"] == 3


# ---------------------------------------------------------------------------
# the NMR passes: K10 (weights, coordinate map, foreground), K11 (the
# coordinate map's VJP), K12 (the NMR coordinate gradient)


def _same_bits(got, want):
    """The same bits, a NaN matched by a NaN (whatever its payload)."""
    nan = want.isnan()
    return (torch.equal(got.isnan(), nan)
            and torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                            want.masked_fill(nan, 0).view(torch.int32)))


def _winner_planes_on(cuda, seed, bs, rows, S, case):
    """Winner planes [bs, 9, rows, S], an index map and a cotangent of the
    coordinate map as the step gives them: 0 on background (everywhere when
    ``case`` is "background"), winners whose vertices 1 and 2 coincide (a
    weight of exactly 0, negated where the winner is clockwise), zeros in
    the cotangent, and NaN planted in an XY plane when ``case`` is "nan"."""
    rng = np.random.RandomState(seed)
    fvm = rng.uniform(-1.2, 1.2, (bs, 9, rows, S)).astype(np.float32)
    fim = rng.randint(0, 40, (bs, rows, S)).astype(np.int32)
    fim[rng.rand(bs, rows, S) < 0.3] = -1
    if case == "background":
        fim[:] = -1
    same = rng.rand(bs, rows, S) < 0.15
    for coord in range(2):
        fvm[:, 6 + coord][same] = fvm[:, 3 + coord][same]
    fvm *= (fim >= 0)[:, None]
    if case == "nan":
        fvm[0, 3, rows - 1, : S // 2] = np.nan
        fvm[-1, 1, 0, 1] = np.nan
    g = rng.randn(bs, 2, rows, S).astype(np.float32)
    g[..., ::5] = 0.0
    return tuple(torch.tensor(a, device=cuda) for a in (fvm, fim, g))


# (bs, rows, S, row_start): 64^2 with anti-aliasing (its 128^2 render), a
# 100-wide image (not a power of two) whole and as a band from row 37, and
# 512^2
PLANE_SHAPES = [(1, 128, 128, 0), (32, 100, 100, 0), (1, 23, 100, 37), (32, 512, 512, 0)]


@pytest.mark.parametrize("case", ["random", "nan", "background"])
@pytest.mark.parametrize("bs,rows,S,row_start", PLANE_SHAPES)
def test_nmr_planes_and_their_vjp_are_bit_exact(cuda, bs, rows, S, row_start, case):
    """K10 (with and without the weight planes) and K11 give their plain
    versions' bits, on the winner planes as the resolve writes them and as
    a slice of a larger map (the face-sharded path's)."""
    fvm, fim, g = _winner_planes_on(cuda, bs * 1000 + S + row_start, bs, rows, S, case)
    sliced = torch.cat([fvm, torch.ones_like(fvm[:, :4])], 1)[:, :9]
    rc.reset_launches()
    for planes in (fvm, sliced):
        for weights in (False, True):
            got = rc.nmr_planes(planes, fim, S, row_start, weights)
            with rc.plain_versions():
                want = rc.nmr_planes(planes, fim, S, row_start, weights)
            assert (got[1] is None) == (not weights)
            for k, (a, b) in enumerate(zip(got, want)):
                assert (a is None and b is None) or _same_bits(a, b), (planes is sliced, k)
        got = rc.nmr_planes_vjp(g, planes, fim, S, row_start)
        with rc.plain_versions():
            want = rc.nmr_planes_vjp(g, planes, fim, S, row_start)
        assert _same_bits(got, want)
    assert rc.LAUNCHES["nmr_planes"] == 4 and rc.LAUNCHES["nmr_planes_vjp"] == 2
    assert rc.LAUNCHES["nmr_plain"] == 6
    if case == "background":
        assert not got.any()
    elif case == "nan":
        assert bool(got.isnan().any())


def _nmr_images(cuda, seed, bs, C, rows, W):
    """Images (a silhouette's 0/1 steps at C = 1) and their gradient [bs, C,
    rows, W]: in the left third of the columns the gradient is scaled down
    so that its pair terms lie within the tie band (1e-4) of each other,
    and a NaN is planted in each."""
    rng = np.random.RandomState(seed)
    images = rng.rand(bs, C, rows, W).astype(np.float32)
    if C == 1:
        images = (images > 0.5).astype(np.float32)
    grad = rng.randn(bs, C, rows, W).astype(np.float32)
    grad[..., : W // 3] *= 2e-5 / rows
    images[0, C - 1, rows // 2, W // 2] = np.nan
    grad[-1, 0, rows // 3, W - 2] = np.nan
    return torch.tensor(images, device=cuda), torch.tensor(grad, device=cuda)


# (bs, rows, W): 64^2 with anti-aliasing (its 128^2 render), 100^2 and 512^2
GRAD_SHAPES = [(1, 128, 128), (32, 100, 100), (32, 512, 512)]


@pytest.mark.parametrize("C", [1, 4, 5])
@pytest.mark.parametrize("bs,rows,W", GRAD_SHAPES)
def test_nmr_coordinate_grad_is_bit_exact(cuda, bs, rows, W, C):
    """K12 gives its plain version's bits (its channel sum adds as
    ``torch.sum`` does on the card), over the whole image and over three
    bands with their halo rows as the sharded entry gathers them (the
    middle band has both), whose rows are the whole image's."""
    from neural_renderer_v2_pytorch_tpu_torch import parallel
    from neural_renderer_v2_pytorch_tpu_torch.parallel import render

    images, grad = _nmr_images(cuda, bs * 10 + C + rows, bs, C, rows, W)
    rc.reset_launches()
    whole = rc.nmr_coordinate_grad(images, grad, None, None, rows)
    with rc.plain_versions():
        want = rc.nmr_coordinate_grad(images, grad, None, None, rows)
    assert _same_bits(whole, want)
    assert bool(whole.isnan().any()) and bool((whole == 0).any()) and bool((whole != 0).any())

    band = parallel.band_rows(rows, False, 3)
    cut = [(images[:, :, r0:r0 + band], grad[:, :, r0:r0 + band]) for r0 in range(0, rows, band)]
    halo = torch.stack([render._band_edges(i, g) for i, g in cut])
    for t, (i, g) in enumerate(cut):
        got = render._band_grad(i, g, halo, t, band, rows)
        with rc.plain_versions():
            plain = render._band_grad(i, g, halo, t, band, rows)
        assert _same_bits(got, plain), t
        assert _same_bits(got, whole[:, :, t * band:t * band + i.shape[2]]), t
    assert rc.LAUNCHES["nmr_coordinate_grad"] == 1 + len(cut)


def test_nmr_coordinate_grad_at_the_tie_band(cuda):
    """Pair terms |r - l| at exactly float32(1e-4), the tie band's edge
    (``differentiation.maximum`` compares in float32, as torch compares a
    float32 tensor with a Python scalar), just inside and just outside it,
    and exact ties, at 64^2 with anti-aliasing (step 1/64)."""
    eps = float(np.float32(1e-4))
    images = torch.zeros(1, 1, 128, 128, device=cuda)
    images[:, :, :, 1::4] = 1.0                # columns j = 1 mod 4 lit, alone
    grad = torch.zeros_like(images)
    # at a lit column j: r = (G[j] - G[j + 1]) * 64, l = (G[j] - G[j - 1]) * 64
    edge = [eps, np.nextafter(np.float32(eps), np.float32(0)), np.nextafter(np.float32(eps),
                                                                         np.float32(1)), 0.0]
    for row, d in enumerate(edge):
        grad[0, 0, row, 2::4] = -float(d) / 64     # r = d, l = 0
        grad[0, 0, 64 + row, 0::4] = -float(d) / 64
        grad[0, 0, 64 + row, 2::4] = -float(d) / 64    # r = l = d: a tie
    got = rc.nmr_coordinate_grad(images, grad, None, None, 128)
    with rc.plain_versions():
        want = rc.nmr_coordinate_grad(images, grad, None, None, 128)
    assert _same_bits(got, want)
    x = want[0, 0, :, 1].tolist()
    assert x[0] == -eps and x[1] == 0.0 and x[2] != 0.0 and x[64:68] == [0.0] * 4


# ---------------------------------------------------------------------------
# the compiled core: graphs captured per signature, replayed after


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty cache of faces records and graphs for the test."""
    monkeypatch.setattr(graphs, "_records", {})
    monkeypatch.setattr(graphs, "_entries", collections.OrderedDict())


def _graph_scene(kind, cuda):
    """A full-path scene at 64^2 AA: (renderer, vertices, faces, step), ``step(x)``
    -> (images, {name: gradient}) of sum(images^2) through the user's
    entry point, with fresh lights (and, at ``atlas``, an atlas that takes
    gradients) each call."""
    r = nr.Renderer(cuda)
    r.image_size = 64
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 20)
    if kind == "bench":
        v, f = torus(40, 32)
        faces = torch.tensor(f, device=cuda)

        def step(x):
            x = x.clone().requires_grad_(True)
            images = r.render_silhouettes(x, faces)
            (torch.sum(images * images) / (torch.sum(images) + 1.0)).backward()
            return images, {"vertices": x.grad}
        return r, torch.tensor(v[None], device=cuda), faces, step
    if kind == "atlas":
        v, f, vt, ft, tex = atlas_scene(16, 12, 40, 64)
        lights = None
    else:
        v, f, vt, ft, tex = texel_scene(16, 12, 2)
        r.texture_size, lights = 2, lit_light_arrays()
    faces, vt, ft = (torch.tensor(a, device=cuda) for a in (f, vt, ft))
    tex = torch.tensor(tex, device=cuda)
    cls = {"ambient": nr.AmbientLight, "directional": nr.DirectionalLight,
           "specular": nr.SpecularLight}

    def step(x):
        x = x.clone().requires_grad_(True)
        t = tex.clone().requires_grad_(kind == "atlas")
        ls = None if lights is None else tuple(
            cls[k](**{n: torch.tensor(a, device=cuda, requires_grad=n == "color")
                      for n, a in arrays.items()}) for k, arrays in lights)
        images = r.render(x, faces, vt, ft, t, lights=ls)
        torch.sum(images * images).backward()
        grads = {"vertices": x.grad}
        if t.grad is not None:
            grads["textures"] = t.grad
        for i, light in enumerate(ls or ()):
            grads[f"light{i}"] = light.color.grad
        return images, grads
    return r, torch.tensor(v[None], device=cuda), faces, step


def _only_graph(faces):
    """The one graph kept over ``faces``."""
    kept = graphs.kept_graphs(faces)
    assert len(kept) == 1, kept
    return kept[0]


@pytest.mark.parametrize("kind", ["bench", "atlas", "lit"])
def test_graphed_core_replays_the_eager_steps_kernels(cuda, fresh_cache, kind):
    """The first call runs eagerly, the second captures, every call from
    the second replays; images equal the eager step's bits and gradients
    lie within 1e-4 of its largest (K3's and K6's atomics); the graphs hold
    the kernels the eager step launches, as many times."""
    r, v, faces, step = _graph_scene(kind, cuda)
    rc.reset_launches()
    with nr.eager():
        want_images, want = step(v)
    eager_launches = {k: n for k, n in rc.LAUNCHES.items() if n}
    rc.reset_launches()
    for call in range(4):
        images, grads = step(v)
        assert rc.GRAPHS["captures"] == min(call, 1)
        assert rc.GRAPHS["forward_replays"] == rc.GRAPHS["backward_replays"] == call
        assert torch.equal(images, want_images)
        for name, g in grads.items():
            torch.testing.assert_close(g, want[name], rtol=0,
                                       atol=1e-4 * float(want[name].abs().max()))
    graph = _only_graph(faces)
    held = dict(graph.launches["forward"])
    for k, n in graph.launches["backward"].items():
        held[k] = held.get(k, 0) + n
    assert held == eager_launches, (held, eager_launches)
    assert graph.seconds > 0
    assert rc.LAUNCHES["face_setup"] == 0 and rc.LAUNCHES["bin_faces"] == 0


def test_graphed_outputs_and_gradients_are_fresh_tensors(cuda, fresh_cache):
    """Step t's images and ``.grad`` are unchanged by step t + 1 (new vertex
    values, which its images reflect), and neither is the graph's buffer."""
    r, v, faces, step = _graph_scene("bench", cuda)
    step(v)                                    # the first call: eager
    first_images, first = step(v)
    kept = (first_images.clone(), first["vertices"].clone())
    moved = v * 1.1
    second_images, second = step(moved)
    assert rc.GRAPHS["forward_replays"] >= 2
    assert torch.equal(first_images, kept[0]) and torch.equal(first["vertices"], kept[1])
    assert not torch.equal(second_images, first_images)
    with nr.eager():
        want_images, want = step(moved)
    assert torch.equal(second_images, want_images)
    graph = _only_graph(faces)
    buffers = {graph.output.data_ptr(), *(g.data_ptr() for g in graph.grads if g is not None)}
    for t in (first_images, second_images, first["vertices"], second["vertices"]):
        assert t.data_ptr() not in buffers


def _silhouette_ndc(cuda):
    v, f = torus(40, 32)
    r = nr.Renderer(cuda)
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 20)
    return r.transform_vertices(torch.tensor(v[None], device=cuda)).detach(), f


def test_int64_faces_give_one_capture_and_one_slot_table(cuda, fresh_cache):
    """Ten steps over one int64 faces tensor: one int32 conversion, one K4
    table and one capture (at the second step); then an in-place edit of
    the faces runs its first call eagerly, recaptures at its second, and
    both render the edited mesh."""
    ndc, f = _silhouette_ndc(cuda)
    faces = torch.tensor(f, device=cuda).long()
    hp = nr.RasterizeHyperparam(image_size=64)
    rc.reset_launches()
    for _ in range(10):
        x = ndc.clone().requires_grad_(True)
        nr.rasterize_silhouettes(x, faces, None, hp).sum().backward()
    assert rc.GRAPHS["captures"] == 1 and rc.SLOT_TABLE_BUILDS == 1
    assert rc.GRAPHS["forward_replays"] == 9
    before = nr.rasterize_silhouettes(ndc.clone().requires_grad_(True), faces, None, hp)
    nf = faces.shape[0]
    faces[: nf // 2] = faces[nf // 2:].clone()             # in place: half the mesh gone
    edited = [nr.rasterize_silhouettes(ndc.clone().requires_grad_(True), faces, None, hp)
              for _ in range(2)]
    assert rc.GRAPHS["captures"] == 2
    with nr.eager():
        want = nr.rasterize_silhouettes(ndc, faces, None, hp)
    for e in edited:
        assert torch.equal(e.detach(), want) and not torch.equal(e, before)


def test_fresh_faces_tensors_each_step_bound_the_captures(cuda, fresh_cache):
    """``faces.int()`` at every step, or a mesh of new ids at every step:
    each call is its faces tensor's first, which runs eagerly, so nothing
    is captured, and the images are the eager step's."""
    ndc, f = _silhouette_ndc(cuda)
    faces = torch.tensor(f, device=cuda).long()
    hp = nr.RasterizeHyperparam(image_size=64)
    with nr.eager():
        want = nr.rasterize_silhouettes(ndc, faces, None, hp)
    rc.reset_launches()
    for k in range(6):
        x = ndc.clone().requires_grad_(True)
        images = nr.rasterize_silhouettes(x, faces.int(), None, hp)
        images.sum().backward()
        assert torch.equal(images.detach(), want)
        # the same triangles in another order: new ids
        turned = faces.roll(k + 1, dims=0).int()
        nr.rasterize_silhouettes(x.detach().requires_grad_(True), turned, None,
                                 hp).sum().backward()
    assert rc.GRAPHS["captures"] == 0 and rc.GRAPHS["forward_replays"] == 0
    assert graphs.graph_count() == 0 and rc.LAUNCHES["resolve_xy"] == 12


def test_graphs_kept_stay_within_the_caps(cuda, fresh_cache):
    """A render at more batch sizes than the cache keeps, twice each: the
    graphs kept stay within MAX_ENTRIES signatures, and an evicted graph
    is freed, with its memory pool."""
    ndc, f = _silhouette_ndc(cuda)
    faces = torch.tensor(f, device=cuda)
    hp = nr.RasterizeHyperparam(image_size=64)
    rc.reset_launches()
    first = None
    for bs in range(1, graphs.MAX_ENTRIES + 5):
        for _ in range(2):
            x = ndc.expand(bs, -1, -1).clone().requires_grad_(True)
            nr.rasterize_silhouettes(x, faces, None, hp).sum().backward()
        assert len(graphs._entries) <= graphs.MAX_ENTRIES
        assert graphs.graph_count() <= graphs.MAX_ENTRIES
        if first is None:
            first = weakref.ref(_only_graph(faces))
    assert rc.GRAPHS["captures"] == graphs.MAX_ENTRIES + 4
    assert len(graphs.kept_graphs(faces)) == graphs.MAX_ENTRIES
    gc.collect()
    assert first() is None                     # evicted: its graphs and pool freed


@pytest.mark.parametrize("kind", ["bench", "lit"])
def test_binned_route_replays_graphs(cuda, fresh_cache, kind):
    """The binned route forced: the second call captures (K7 in its capped
    form, at twice the warm-up's pair total to a power of two), later calls
    replay; images equal the eager step's, gradients within 1e-4, the
    graphs hold the eager step's launches, and no replay overflows."""
    r, v, faces, step = _graph_scene(kind, cuda)
    with rc.forced_route("binned"):
        rc.reset_launches()
        with nr.eager():
            want_images, want = step(v)
        eager_launches = {k: n for k, n in rc.LAUNCHES.items() if n}
        rc.reset_launches()
        for call in range(4):
            images, grads = step(v)
            assert rc.GRAPHS["captures"] == min(call, 1)
            assert rc.GRAPHS["forward_replays"] == call
            assert torch.equal(images, want_images)
            for name, g in grads.items():
                torch.testing.assert_close(g, want[name], rtol=0,
                                           atol=1e-4 * float(want[name].abs().max()))
    torch.cuda.synchronize()
    graph = _only_graph(faces)
    held = collections.Counter(graph.launches["forward"])
    held.update(graph.launches.get("backward", {}))
    assert dict(held) == eager_launches and eager_launches["bin_faces"] == 1
    (total,) = graphs.faces_record(faces).bin_totals.values()
    assert graph.capacities == [graphs.bin_capacity(total)]
    assert graph.overflowed() == 0 and rc.GRAPHS["overflow_recaptures"] == 0


def test_binned_overflow_replay_is_exact_and_recaptures(cuda, fresh_cache, caplog):
    """A graph captured with a quarter of the pair total's slots: its replay
    gives the eager bits over overflow bins and reports them once it has
    finished; the next call drops it, logs it and captures anew at twice the
    capacity, which fits."""
    import logging

    r, v, faces, step = _graph_scene("bench", cuda)
    with rc.forced_route("binned"):
        with nr.eager():
            want_images, want = step(v)
        rc.reset_launches()
        step(v)                                        # the first call: eager
        (total,) = graphs.faces_record(faces).bin_totals.values()
        with graphs.forced_capacity(total // 4):
            images, _ = step(v)
        assert torch.equal(images, want_images)
        torch.cuda.synchronize()
        graph = _only_graph(faces)
        assert graph.capacities == [total // 4] and graph.overflowed() > 0
        with caplog.at_level(logging.INFO, logger=graphs.__name__):
            images, grads = step(v)
        assert torch.equal(images, want_images)
        torch.testing.assert_close(grads["vertices"], want["vertices"], rtol=0,
                                   atol=1e-4 * float(want["vertices"].abs().max()))
        assert rc.GRAPHS["overflow_recaptures"] == 1 and rc.GRAPHS["captures"] == 2
        assert any("overflow bins" in rec.getMessage() for rec in caplog.records)
        again = _only_graph(faces)
        assert again is not graph and again.capacities[0] >= 2 * (total // 4)
        step(v)
        torch.cuda.synchronize()
        assert again.overflowed() == 0 and rc.GRAPHS["captures"] == 2


def _whole_step_graph(step, v):
    """``step`` (a ``_graph_scene`` step) captured whole by its caller after
    two eager warm-up steps: (graph, images, {name: gradient}, the kernels
    it holds)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), nr.eager():
        for _ in range(2):
            step(v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(rc.LAUNCHES)
    with torch.cuda.graph(graph):
        images, grads = step(v)
    held = {k: n - before[k] for k, n in rc.LAUNCHES.items() if n > before[k]}
    return graph, images, grads, held


@pytest.mark.parametrize("route", ["tiled", "binned"])
def test_port_spans_in_a_callers_graph(cuda, fresh_cache, route):
    """A whole step captured by its caller with the port's spans on holds the
    same kernels as with them off (a span marks the stream with external
    events, no kernel), as many device records a replay under the
    profiler, and the same bits; after a replay ``trace.sample`` reads
    each stage's device ms from the span's own marks (one ``nmr.grad``, the
    K12 launch), and the outermost spans fit inside the replay's time.
    The step on the plain versions, eagerly, has the NMR gradient's y and
    x passes in spans inside ``nmr.grad``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neural_renderer_v2_pytorch_tpu_torch.utils import trace

    r, v, faces, step = _graph_scene("bench", cuda)
    forms = {}
    with rc.forced_route(route):
        for on in (False, True):
            if on:
                trace.enable()
            try:
                graph, images, grads, held = _whole_step_graph(step, v)
                trace.clear()
                graph.replay()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    graph.replay()
                    torch.cuda.synchronize()
                records = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                torch.cuda.synchronize()
                readings = trace.sample()
                stages = trace.device_ms()
                outer = trace.device_ms(outermost=True)
            finally:
                trace.disable()
            forms[on] = dict(held=held, records=len(records), images=images.clone(),
                             grad=grads["vertices"].clone(), read=len(readings),
                             names=collections.Counter(r["name"] for r in readings),
                             stages=stages, outer=outer, ms=start.elapsed_time(end))
    off, on = forms[False], forms[True]
    assert on["held"] == off["held"] and on["records"] == off["records"]
    assert torch.equal(on["images"], off["images"])
    assert off["read"] == 0 and not off["stages"]
    assert on["read"] > 0
    for name in ("camera", "gather", "resolve", "planes", "pool", "pool.vjp", "nmr.grad",
                 "planes.vjp", "resolve.vjp", "gather.vjp", "camera.vjp"):
        assert on["stages"][name] > 0, (name, on["stages"])
    # on the kernels the NMR gradient is one launch (K12) in ``nmr.grad``;
    # its plain version's y and x passes have spans of their own inside it
    assert on["names"]["nmr.grad"] == 1
    assert "nmr.grad.y" not in on["stages"] and "nmr.grad.x" not in on["stages"]
    assert sum(on["outer"].values()) <= on["ms"]
    trace.enable()
    try:
        with rc.forced_route(route), rc.plain_versions(), nr.eager():
            step(v)
        plain, outer = trace.device_ms(), trace.device_ms(outermost=True)
    finally:
        trace.disable()
        trace.clear()
    assert plain["nmr.grad.y"] > 0 and plain["nmr.grad.x"] > 0
    assert plain["nmr.grad.y"] + plain["nmr.grad.x"] <= plain["nmr.grad"]
    assert "nmr.grad.y" not in outer


def test_sample_reads_each_replayed_graph_once(cuda, fresh_cache):
    """With the port's spans on, ``trace.sample`` after each step reads the
    spans of the graph that step replayed, once: after an overflow the
    dropped graph's spans are not read beside its recapture's, and of two
    callers' graphs replayed in turn each is read after its own replay
    and not again."""
    from neural_renderer_v2_pytorch_tpu_torch.utils import trace

    r, v, faces, step = _graph_scene("bench", cuda)
    trace.enable()
    try:
        with rc.forced_route("binned"):
            rc.reset_launches()
            step(v)                                    # the first call: eager
            (total,) = graphs.faces_record(faces).bin_totals.values()
            with graphs.forced_capacity(total // 4):
                step(v)
            dropped = _only_graph(faces)
            first = collections.Counter(s["name"] for s in trace.sample())
            steps = []
            for _ in range(3):
                step(v)
                steps.append(collections.Counter(s["name"] for s in trace.sample()))
            assert _only_graph(faces) is not dropped
            assert rc.GRAPHS["overflow_recaptures"] == 1
            callers = [_whole_step_graph(step, v)[0] for _ in range(2)]
            read = []
            for graph in callers:
                graph.replay()
                read.append(collections.Counter(s["name"] for s in trace.sample()))
                read.append(trace.sample())
    finally:
        trace.disable()
        trace.clear()
    assert first["resolve"] == 1 and steps == [first] * 3
    assert read[0]["resolve"] == 1 and read[2] == read[0] and read[1] == read[3] == []


def test_callers_graph_overflow_is_counted(cuda, fresh_cache):
    """A binned whole step captured by its caller with a quarter of its pair
    total's slots: each replay gives the eager bits, and K7's counts
    (``graphs.bin_counters``) grow by one binning, the pair total, the
    slots and exactly the overflow word that K7 wrote in that replay."""
    r, v, faces, step = _graph_scene("bench", cuda)
    words, bin_faces = [], rc.bin_faces

    def keep_words(*args, capacity=None, **kwargs):
        out = bin_faces(*args, capacity=capacity, **kwargs)
        if capacity is not None:
            words.append(out[3])
        return out

    with rc.forced_route("binned"):
        with nr.eager():
            want_images, want = step(v)
        (total,) = graphs.faces_record(faces).bin_totals.values()
        with graphs.forced_capacity(total // 4), _patch.object(rc, "bin_faces", keep_words):
            graph, images, grads, _ = _whole_step_graph(step, v)
        assert len(words) == 1
        counts = graphs.bin_counters()
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(images, want_images)
            now = graphs.bin_counters()
            overflow = int(words[0])
            assert overflow > 0
            assert {k: now[k] - counts[k] for k in now} == dict(
                binnings=1, pairs=total, slots=total // 4, overflow_bins=overflow)
            counts = now


def test_a_captured_silhouette_step_launches_each_nmr_kernel_once(cuda, fresh_cache):
    """One silhouette step, eager or captured by its caller, launches K10,
    K11 and K12 once each and takes no plain version of an NMR pass."""
    r, v, faces, step = _graph_scene("bench", cuda)
    nmr = ("nmr_planes", "nmr_planes_vjp", "nmr_coordinate_grad")
    rc.reset_launches()
    with nr.eager():
        step(v)
    assert [rc.LAUNCHES[k] for k in nmr] == [1, 1, 1] and rc.LAUNCHES["nmr_plain"] == 0
    held = _whole_step_graph(step, v)[3]
    assert [held.get(k) for k in nmr] == [1, 1, 1] and "nmr_plain" not in held, held


def _depth_and_lit_steps(kind, cuda):
    """(vertices, step) of ``_graph_scene``'s kind: depth of its bench scene,
    or its lit scene with the lights made once (a caller's capture copies
    nothing from the host); ``atlas-lit``: its atlas scene under the lit
    scene's lights."""
    if kind == "depth":
        r, v, faces, _ = _graph_scene("bench", cuda)

        def render(x):
            return r.render_depth(x, faces)
    else:
        r, v, faces, _ = _graph_scene("atlas" if kind == "atlas-lit" else "lit", cuda)
        _, _, vt, ft, tex = (atlas_scene(16, 12, 40, 64) if kind == "atlas-lit"
                             else texel_scene(16, 12, 2))
        vt, ft, tex = (torch.tensor(a, device=cuda) for a in (vt, ft, tex))
        cls = {"ambient": nr.AmbientLight, "directional": nr.DirectionalLight,
               "specular": nr.SpecularLight}
        lights = tuple(cls[k](**{n: torch.tensor(a, device=cuda) for n, a in arrays.items()})
                       for k, arrays in lit_light_arrays())

        def render(x):
            # the atlas-lit scene's atlas takes gradients, a fresh leaf each step
            t = tex.clone().requires_grad_(True) if kind == "atlas-lit" else tex
            return r.render(x, faces, vt, ft, t, lights=lights)

    def step(x):
        x = x.clone().requires_grad_(True)
        images = render(x)
        torch.sum(images * images).backward()
        return images, {"vertices": x.grad}
    return v, step


@pytest.mark.parametrize("kind", ["bench", "depth", "atlas", "lit"])
def test_renders_through_the_nmr_kernels_give_the_plain_paths_bits(cuda, fresh_cache, kind):
    """Silhouettes, depth, RGBA from an atlas and textured-lit RGBA, each
    step captured whole by its caller on the kernels, against the eager
    step on the plain versions: each replay's images and the cotangent
    that reaches the resolve (K3's input: K11's XY planes and the shading's
    z planes summed by autograd) have the same bits; the gradients lie
    within 1e-4 of their largest (K3's and K14's atomics)."""
    from neural_renderer_v2_pytorch_tpu_torch.ops import gather_resolve

    if kind in ("depth", "lit"):
        v, step = _depth_and_lit_steps(kind, cuda)
    else:
        _, v, _, step = _graph_scene(kind, cuda)
    seen, scatter = [], gather_resolve.scatter_pixels_to_faces

    def keep(grad, *args):
        seen.append(grad.clone())
        return scatter(grad, *args)

    with _patch.object(gather_resolve, "scatter_pixels_to_faces", keep):
        with rc.plain_versions(), nr.eager():
            want_images, want = step(v)
        want_cotangent = seen[-1]
        graph, images, grads, held = _whole_step_graph(step, v)
    assert [held.get(k) for k in ("nmr_planes", "nmr_planes_vjp", "nmr_coordinate_grad")] == \
        [1, 1, 1] and "nmr_plain" not in held, held
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(images, want_images)
        assert _same_bits(seen[-1], want_cotangent)
        for name, g in grads.items():
            torch.testing.assert_close(g, want[name], rtol=0,
                                       atol=1e-4 * float(want[name].abs().max()))


def test_float64_lights_and_backgrounds_render_through_the_nmr_kernels(cuda):
    """Float64 light fields and backgrounds are read in float32, as the JAX
    package reads them (x64 off): a lit render over them runs the NMR
    kernels and no plain version, with the images of their float32 copies
    (the gradients within 1e-4 of their largest: K3's and K6's atomics).
    An NMR pass given CUDA tensors of another dtype raises."""
    r, v, faces, _ = _graph_scene("lit", cuda)
    _, _, vt, ft, tex = texel_scene(16, 12, 2)
    vt, ft, tex = (torch.tensor(a, device=cuda) for a in (vt, ft, tex))
    cls = {"ambient": nr.AmbientLight, "directional": nr.DirectionalLight,
           "specular": nr.SpecularLight}
    S = 2 * r.image_size
    rng = np.random.RandomState(7)
    backgrounds = torch.tensor(rng.rand(1, 3, S, S), device=cuda)
    fields = [(k, {n: torch.tensor(a.astype(np.float64) * (1 + 1e-9 * rng.rand(*a.shape)),
                                   device=cuda) for n, a in arrays.items()})
              for k, arrays in lit_light_arrays()]

    def step(dtype):
        x = v.clone().requires_grad_(True)
        lights = tuple(cls[k](**{n: a.to(dtype) for n, a in f.items()}) for k, f in fields)
        images = r.render(x, faces, vt, ft, tex, backgrounds=backgrounds.to(dtype),
                          lights=lights)
        torch.sum(images * images).backward()
        return images, x.grad

    with nr.eager():
        rc.reset_launches()
        images, grad = step(torch.float64)
        launches = dict(rc.LAUNCHES)
        want_images, want_grad = step(torch.float32)
    assert images.dtype == torch.float32 and torch.equal(images, want_images)
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=1e-4 * float(want_grad.abs().max()))
    assert [launches[k] for k in ("nmr_planes", "nmr_planes_vjp", "nmr_coordinate_grad")] == \
        [1, 1, 1] and launches["nmr_plain"] == 0, launches
    fvm = torch.rand((1, 9, 8, 8), device=cuda)
    fim = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="nmr_planes: want torch.float32"):
        rc.nmr_planes(fvm.double(), fim, 8)
    with pytest.raises(ValueError, match="nmr_planes_vjp: want torch.int32"):
        rc.nmr_planes_vjp(fvm[:, :2], fvm, fim.long(), 8)
    with pytest.raises(ValueError, match="nmr_coordinate_grad: want torch.float32"):
        rc.nmr_coordinate_grad(fvm.double(), fvm.double(), None, None, 8)


# the loaded-atlas sampler (K13, K14): (bs, H, W, th, tw) small, with an odd
# atlas width and texel count (float2 pairs unaligned in every other
# plane), and the benchmark cell atlas-fit-256's (32 views of 512^2, a 1190
# x 1920 atlas)
SAMPLER_SHAPES = [(2, 12, 16, 40, 64), (3, 33, 47, 23, 37), (32, 512, 512, 1190, 1920)]


def _sampler_on(cuda, seed, bs, H, W, th, tw, shared):
    """The sampler's inputs as a render passes them: the z planes of winner
    planes [bs, 9, H, W] and the texel-coordinate planes of attribute planes
    [bs, 15, H, W] (strided views), the atlas (``shared``: one [1, 3, th,
    tw] expanded over the batch, batch stride 0), an index map with about a
    third background and weights summing to 1.  A quarter of the pixels
    have weights (1, 0, 0) at depth 1, so that x lies exactly at the
    uv-bbox's lo and y at hi - eps (ties), and an eighth lie past the
    atlas's last column and row (the anchor's clamp)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=cuda)

    fvm = rand(bs, 9, H, W) * 2 - 1
    fvm[:, 2::3] = 0.5 + 2.5 * rand(bs, 3, H, W)
    attrs = rand(bs, 15, H, W)
    attrs[:, 0:6:2] *= tw - 1
    attrs[:, 1:6:2] *= th - 1
    w = rand(bs, 3, H, W)
    w = w / w.sum(1, keepdim=True)
    fim = torch.randint(0, 1000, (bs, H, W), generator=gen, device=cuda, dtype=torch.int32)
    fim[rand(bs, H, W) < 0.3] = -1
    group = torch.randint(0, 8, (bs, H, W), generator=gen, device=cuda)
    tie, edge = group < 2, group == 2
    w[:, 0][tie], w[:, 1][tie], w[:, 2][tie] = 1.0, 0.0, 0.0
    fvm[:, 2][tie] = 1.0
    u, v = attrs[:, 0:6:2], attrs[:, 1:6:2]
    u[:, 1][tie] = u[:, 0][tie] + 0.75 * (tw - 1 - u[:, 0][tie])
    u[:, 2][tie] = u[:, 0][tie] + 0.25 * (tw - 1 - u[:, 0][tie])
    v[:, 1][tie] = float(th - 2)
    v[:, 2][tie] = 0.5
    v[:, 0][tie] = v[:, 1][tie] - 1e-5
    for k in range(3):
        u[:, k][edge], v[:, k][edge] = tw - 0.5, th - 0.5
    atlas = rand(1 if shared else bs, 3, th, tw)
    if shared:
        atlas = atlas.expand(bs, -1, -1, -1)
    return fvm[:, 2::3], attrs[:, :6], atlas, fim, w


def _atlas_sum_bound(grad, z, uv, atlas, fim, w):
    """Per texel of the atlas gradient, twice the float32 rounding that a
    sum of its n terms may carry in any order: 2 n 2^-24 sum |term|.  K14
    adds a texel's terms with atomics and the plain version with an
    index_add_ and K6's fold, each in its own order; each lies within n
    2^-24 sum |term| of the exact sum (the terms themselves, g_c t_i, are
    the same products in both)."""
    fg, _, _, tap_w, anchors, _ = rc._atlas_parts(z, uv, atlas, fim, w, 1e-5)
    bs, _, th, tw = atlas.shape
    P = anchors.shape[-1]
    g = torch.where(fg[:, None], grad, 0.0)
    terms = torch.cat([g * t[:, None] for t in tap_w], 1).reshape(bs, 12, P)
    marked = torch.where(fg.reshape(bs, P), anchors[:, 0].int(), -1)
    size = rc.atlas_taps_grad_plain(terms.abs(), marked, tw, th * tw)
    count = rc.atlas_taps_grad_plain((terms != 0).float(), marked, tw, th * tw)
    return (2 * count * 2.0 ** -24 * size).reshape(atlas.shape)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("bs,H,W,th,tw", SAMPLER_SHAPES)
def test_atlas_sampler_kernels_match_their_plain_versions(cuda, bs, H, W, th, tw, shared):
    """K13 gives its plain version's bits; K14 gives the plain VJP's bits for
    the depths', texel coordinates' and weights' gradients and writes only
    those asked for; its atlas gradient lies within the rounding of its
    texels' sums (:func:`_atlas_sum_bound`: atomics against an index_add_
    and K6's fold)."""
    z, uv, atlas, fim, w = _sampler_on(cuda, bs + H + th, bs, H, W, th, tw, shared)
    rc.reset_launches()
    got = rc.atlas_sample(z, uv, atlas, fim, w, 1e-5)
    with rc.plain_versions():
        want = rc.atlas_sample(z, uv, atlas, fim, w, 1e-5)
    assert got.shape == (bs, 3, H, W) and _same_bits(got, want)
    assert not got[(fim < 0)[:, None].expand_as(got)].any()
    grad = torch.randn((bs, 3, H, W), generator=torch.Generator(device=cuda).manual_seed(bs),
                       device=cuda)
    got = rc.atlas_sample_vjp(grad, z, uv, atlas, fim, w, 1e-5)
    with rc.plain_versions():
        want = rc.atlas_sample_vjp(grad, z, uv, atlas, fim, w, 1e-5)
    for k in (0, 1, 3):
        assert got[k].is_contiguous() and _same_bits(got[k], want[k]), k
    assert got[2].shape == atlas.shape and got[2].is_contiguous()
    assert bool(((got[2] - want[2]).abs() <= _atlas_sum_bound(grad, z, uv, atlas, fim, w)).all())
    part = rc.atlas_sample_vjp(grad, z, uv, atlas, fim, w, 1e-5, (False, True, False, False))
    assert part[0] is None and part[2] is None and part[3] is None
    assert _same_bits(part[1], got[1])
    assert rc.LAUNCHES["atlas_sample"] == 1 and rc.LAUNCHES["atlas_sample_vjp"] == 2


def test_a_captured_lit_rgb_step_launches_each_sampler_kernel_once(cuda, fresh_cache):
    """One lit RGB step from a loaded atlas, eager or captured by its
    caller, launches K13 and K14 once each and K6 not at all; its replays
    give the eager step's images."""
    v, step = _depth_and_lit_steps("atlas-lit", cuda)
    sampler = ("atlas_sample", "atlas_sample_vjp", "atlas_taps_grad")
    rc.reset_launches()
    with nr.eager():
        want_images, _ = step(v)
    assert [rc.LAUNCHES[k] for k in sampler] == [1, 1, 0]
    graph, images, _, held = _whole_step_graph(step, v)
    assert [held.get(k) for k in sampler] == [1, 1, None], held
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(images, want_images)


def test_atlas_sampler_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """On the card the sampler's wrappers take float32 planes and atlas and
    an int32 index map of matching shapes, else raise ValueError (no
    fallback to the plain version)."""
    z, uv, atlas, fim, w = _sampler_on(cuda, 1, 2, 12, 16, 40, 64, False)
    grad = torch.ones((2, 3, 12, 16), device=cuda)
    cases = {
        "z_planes": (z.double(), uv, atlas, fim, w),
        "uv_planes": (z, uv.half(), atlas, fim, w),
        "weight_planes": (z, uv, atlas, fim, w[:, :2]),
        "textures": (z, uv, atlas.double(), fim, w),
        "face_index_map": (z, uv, atlas, fim.long(), w),
    }
    for name, args in cases.items():
        with pytest.raises(ValueError, match=name):
            rc.atlas_sample(*args, 1e-5)
        with pytest.raises(ValueError, match=name):
            rc.atlas_sample_vjp(grad, *args, 1e-5)
    with pytest.raises(ValueError, match="textures"):
        rc.atlas_sample(z, uv, atlas[:, :2], fim, w, 1e-5)
    with pytest.raises(ValueError, match="grad"):
        rc.atlas_sample_vjp(grad.double(), z, uv, atlas, fim, w, 1e-5)
    with pytest.raises(ValueError, match="grad"):
        rc.atlas_sample_vjp(grad[:, :2], z, uv, atlas, fim, w, 1e-5)


# the lights' per-pixel pass (K15, K16): (bs, rows, W) small, odd, and the
# cell atlas-fit-256's 32 views of 512^2; each on whole images and on a band
# of rows whose planes are slices of larger maps (the normals a slice of
# the attribute planes, as a render passes them)
LIGHTS_SHAPES = [(2, 12, 16), (3, 33, 47), (32, 512, 512)]
# the cell's lights (directional, ambient, specular at exponent 1), and
# every kind on either side with exponents 2.5 and 0
LIGHT_SETS = {
    "cell": (("directional", False), ("ambient", False), ("specular", False)),
    "every": (("directional", True), ("specular", True), ("ambient", False),
              ("specular", False), ("directional", False), ("specular", True)),
}


def _lights_on(cuda, seed, bs, rows, W, kinds, band):
    """The lights' inputs as a render passes them: RGB [bs, 3, rows, W], the
    nine normal planes (planes 6-14 of [bs, 15, rows, W] attribute planes)
    and weights summing to 1 (0 on a tenth of background pixels, whose
    normals are 0 too), and the light table [bs, L, 7] of ``kinds``
    (exponents 1 in the cell's set, 2.5, 1 and 0 in the other).  An eighth
    of the pixels have every normal 0 (each kind's dot product exactly 0)
    and another eighth the normals' z 0 (the specular's base exactly 0).
    ``band``: the planes are rows 5 .. of maps 7 rows taller."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=cuda)

    full = rows + 7 if band else rows
    rgb = rand(bs, 4, full, W)
    attrs = rand(bs, 15, full, W) * 2 - 1
    w = rand(bs, 3, full, W)
    w = w / w.sum(1, keepdim=True)
    group = torch.randint(0, 10, (bs, full, W), generator=gen, device=cuda)
    normals = attrs[:, 6:15]
    normals[(group == 0)[:, None].expand_as(normals)] = 0.0
    normals[:, 2::3][(group == 1)[:, None].expand(-1, 3, -1, -1)] = 0.0
    background = (group == 2)[:, None]
    normals[background.expand_as(normals)] = 0.0
    w[background.expand_as(w)] = 0.0
    table = rand(bs, len(kinds), 7)
    table[:, :, 3:6] = table[:, :, 3:6] * 2 - 1
    table[:, :, 6] = 1.0
    if len(kinds) > 3:
        table[:, 1, 6], table[:, 5, 6] = 2.5, 0.0
    if band:
        return rgb[:, :3, 5:5 + rows], attrs[:, 6:15, 5:5 + rows], w[:, :, 5:5 + rows], table
    return rgb[:, :3], normals, w, table


def _table_sum_bound(grad, rgb, normals, weights, table, kinds):
    """Per entry of the light table's gradient, twice the float32 rounding
    that a sum of its n terms may carry in any order: 2 n 2^-24 sum |term|.
    K16 sums an (image, light, field)'s terms over the warps, the blocks
    and the wrapper's torch.sum, its plain version by one torch.sum; the
    terms are the same products in both."""
    terms = rc._lights_vjp_parts(grad, rgb, normals, weights, table, kinds, True)[2]
    n = terms.shape[3] * terms.shape[4]
    return 2 * n * 2.0 ** -24 * terms.abs().sum((3, 4))


@pytest.mark.parametrize("lights", sorted(LIGHT_SETS))
@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("bs,rows,W", LIGHTS_SHAPES)
def test_lights_kernels_match_their_plain_versions(cuda, bs, rows, W, band, lights):
    """K15 gives its plain version's bits; K16 gives the plain VJP's bits for
    the RGB and normal gradients (zero dot products, zero bases and
    background included) and writes only those asked for; its light-table
    gradient lies within the rounding of its sums (:func:`_table_sum_bound`)
    and repeats its bits."""
    kinds = LIGHT_SETS[lights]
    rgb, normals, w, table = _lights_on(cuda, bs + rows + band, bs, rows, W, kinds, band)
    assert not normals.is_contiguous()          # a slice, read in place
    rc.reset_launches()
    got = rc.lights_shade(rgb, normals, w, table, kinds)
    with rc.plain_versions():
        want = rc.lights_shade(rgb, normals, w, table, kinds)
    assert got.shape == (bs, 3, rows, W) and _same_bits(got, want)
    grad = torch.randn((bs, 3, rows, W), generator=torch.Generator(device=cuda).manual_seed(bs),
                       device=cuda)
    got = rc.lights_shade_vjp(grad, rgb, normals, w, table, kinds)
    with rc.plain_versions():
        want = rc.lights_shade_vjp(grad, rgb, normals, w, table, kinds)
    for k in (0, 1):
        assert got[k].is_contiguous() and _same_bits(got[k], want[k]), k
    assert got[2].shape == table.shape
    bound = _table_sum_bound(grad, rgb, normals, w, table, kinds)
    assert bool(((got[2] - want[2]).abs() <= bound).all())
    again = rc.lights_shade_vjp(grad, rgb, normals, w, table, kinds, (False, False, True))
    assert again[0] is None and again[1] is None and torch.equal(again[2], got[2])
    part = rc.lights_shade_vjp(grad, rgb, normals, w, table, kinds, (False, True, False))
    assert part[0] is None and part[2] is None and _same_bits(part[1], got[1])
    assert rc.LAUNCHES["lights_shade"] == 1 and rc.LAUNCHES["lights_shade_vjp"] == 3


def test_a_lit_render_launches_each_lights_kernel_once(cuda, fresh_cache):
    """One lit RGB step launches K15 and K16 once each: eagerly with its
    lights' colours taking gradients, and captured whole by its caller
    (the lights made once, as a capture copies nothing from the host),
    whose replays give the eager step's images; a silhouette step launches
    neither."""
    kernels = ("lights_shade", "lights_shade_vjp")
    _, v, _, step = _graph_scene("lit", cuda)
    rc.reset_launches()
    with nr.eager():
        _, grads = step(v)
    assert [rc.LAUNCHES[k] for k in kernels] == [1, 1]
    assert all(grads[f"light{i}"].abs().max() > 0 for i in range(3)), grads
    v, step = _depth_and_lit_steps("lit", cuda)
    rc.reset_launches()
    with nr.eager():
        want_images, _ = step(v)
    assert [rc.LAUNCHES[k] for k in kernels] == [1, 1]
    graph, images, _, held = _whole_step_graph(step, v)
    assert [held.get(k) for k in kernels] == [1, 1], held
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(images, want_images)
    _, v, _, step = _graph_scene("bench", cuda)
    rc.reset_launches()
    with nr.eager():
        step(v)
    assert [rc.LAUNCHES[k] for k in kernels] == [0, 0]
    assert not any(k in _whole_step_graph(step, v)[3] for k in kernels)


def test_lights_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """On the card the lights' wrappers take float32 planes of matching
    shapes, a float32 [bs, L, 7] table and at most 64 lights, else raise
    ValueError (no fallback to the plain version)."""
    kinds = LIGHT_SETS["cell"]
    rgb, normals, w, table = _lights_on(cuda, 1, 2, 12, 16, kinds, False)
    grad = torch.ones((2, 3, 12, 16), device=cuda)
    cases = {
        "rgb": (rgb.double(), normals, w, table),
        "normals": (rgb, normals[:, :6], w, table),
        "weights": (rgb, normals, w.half(), table),
        "table": (rgb, normals, w, table.double()),
    }
    for name, args in cases.items():
        with pytest.raises(ValueError, match=name):
            rc.lights_shade(*args, kinds)
        with pytest.raises(ValueError, match=name):
            rc.lights_shade_vjp(grad, *args, kinds)
    with pytest.raises(ValueError, match="table"):
        rc.lights_shade(rgb, normals, w, table[:, :2], kinds)
    with pytest.raises(ValueError, match="rgb"):
        rc.lights_shade(rgb[0], normals, w, table, kinds)
    with pytest.raises(ValueError, match="grad"):
        rc.lights_shade_vjp(grad.double(), rgb, normals, w, table, kinds)
    with pytest.raises(ValueError, match="grad"):
        rc.lights_shade_vjp(grad[:, :2], rgb, normals, w, table, kinds)
    many = (("ambient", False),) * (rc.MAX_LIGHTS + 1)
    with pytest.raises(ValueError, match="lights"):
        rc.lights_shade(rgb, normals, w, torch.zeros((2, len(many), 7), device=cuda), many)


def test_no_grad_render_is_a_forward_graph(cuda, fresh_cache):
    r, v, faces, _ = _graph_scene("bench", cuda)
    rc.reset_launches()
    with torch.no_grad():
        got = [r.render_silhouettes(v, faces) for _ in range(3)]
    with nr.eager():
        want = r.render_silhouettes(v, faces)
    assert all(torch.equal(g, want) for g in got)
    assert rc.GRAPHS["captures"] == 1 and rc.GRAPHS["forward_replays"] == 2
    assert rc.GRAPHS["backward_replays"] == 0
    assert got[1].data_ptr() != got[2].data_ptr()


def test_two_views_under_one_loss_take_one_backward(cuda, fresh_cache):
    """Two renders of one signature before one backward (a loss summed over
    two views): each replays a graph of its own, and the gradient is the
    eager step's."""
    r, v, faces, _ = _graph_scene("bench", cuda)
    views = (nr.get_points_from_angles(2.732, 30, 20), nr.get_points_from_angles(2.732, 30, 110))

    def step(x):
        x = x.clone().requires_grad_(True)
        loss = 0.0
        for viewpoint in views:
            r.viewpoints = viewpoint
            images = r.render_silhouettes(x, faces)
            loss = loss + torch.sum(images * images) / (torch.sum(images) + 1.0)
        loss.backward()
        return x.grad

    with nr.eager():
        want = step(v)
    rc.reset_launches()
    for _ in range(3):
        got = step(v)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    assert rc.GRAPHS["captures"] == 2 and len(graphs.kept_graphs(faces)) == 2
    assert rc.GRAPHS["forward_replays"] == rc.GRAPHS["backward_replays"] == 5


def test_a_second_backward_after_a_later_replay_raises(cuda, fresh_cache):
    """A render kept for a second backward (retain_graph) while a later
    render replayed its graph would read the later saved tensors: it
    raises."""
    r, v, faces, _ = _graph_scene("bench", cuda)
    x = v.clone().requires_grad_(True)
    r.render_silhouettes(x, faces)                 # the first call: eager
    first = r.render_silhouettes(x, faces)
    first.sum().backward(retain_graph=True)
    r.render_silhouettes(x * 1.01, faces).sum().backward()
    with pytest.raises(RuntimeError, match="replayed by a later call"):
        first.sum().backward()


@pytest.mark.parametrize("route", ["tiled", "binned"])
def test_caller_captures_a_whole_step(cuda, fresh_cache, route):
    """Camera, render, bench.py's loss, backward and update in one graph of
    the caller's: the render runs straight into it (on the binned route, K7
    capped at the warm-up's total); one replay gives the eager step's
    images, gradient and update."""
    r, v, faces, _ = _graph_scene("bench", cuda)
    x = v.clone().requires_grad_(True)

    def render(x):
        with rc.forced_route(route):
            return r.render_silhouettes(x, faces)

    def step():
        images = render(x)
        loss = torch.sum(images * images) / (torch.sum(images) + 1.0)
        loss.backward()
        with torch.no_grad():
            x.sub_(1e-6 * x.grad)
        return images

    with nr.eager():
        want_x = v.clone().requires_grad_(True)
        want_images = render(want_x)
        (torch.sum(want_images * want_images) / (torch.sum(want_images) + 1.0)).backward()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), nr.eager():
        for _ in range(2):
            x.grad = None
            step()
    torch.cuda.current_stream().wait_stream(side)
    x.grad = None
    graph = torch.cuda.CUDAGraph()
    rc.reset_launches()
    with torch.cuda.graph(graph):
        images = step()
    assert rc.GRAPHS["captures"] == 0
    kernel = "resolve_xy" if route == "tiled" else "resolve_binned_xy"
    assert rc.LAUNCHES[kernel] == 1 and rc.LAUNCHES["bin_faces"] == (route == "binned")
    with torch.no_grad():
        x.copy_(v)
    graph.replay()
    assert torch.equal(images, want_images.detach())
    torch.testing.assert_close(x.grad, want_x.grad, rtol=0,
                               atol=1e-4 * float(want_x.grad.abs().max()))
    assert torch.equal(x.detach(), v - 1e-6 * x.grad)


@pytest.mark.parametrize("route", ["tiled", "binned"])
def test_mixed_batch_on_each_route_matches_the_plain_versions(cuda, fresh_cache, route):
    """The JAX package's mixed batch (``edge_scenes()["mixed"]``: an
    off-screen slot and a one-face slot at 32^2) on ``route``, eager and
    graphed (the second call captures, later calls replay): images and
    index maps equal to the plain versions', the vertex gradient of
    sum(images^2) within 1e-4 of its largest magnitude and zero in the
    empty slot."""
    scene = edge_scenes()["mixed"]
    x = torch.tensor(scene["vertices"], device=cuda)
    faces = torch.tensor(scene["faces"], device=cuda)
    hp = nr.RasterizeHyperparam(image_size=EDGE_SIZE, anti_aliasing=False)

    def step():
        v = x.clone().requires_grad_(True)
        images = nr.rasterize_silhouettes(v, faces, None, hp)
        torch.sum(images ** 2).backward()
        return images.detach(), v.grad

    def index_map():
        return nr.compute_face_index_map(x[:, faces.long()], EDGE_SIZE)

    with rc.forced_route(route):
        with nr.eager(), rc.plain_versions():
            want_images, want = step()
            want_fim = index_map()
        rc.reset_launches()
        with nr.eager():
            got = [step()]
            fims = [index_map()]
        kernel = "resolve_xy" if route == "tiled" else "resolve_binned_xy"
        assert rc.LAUNCHES[kernel] == 1 and rc.LAUNCHES["bin_faces"] == 2 * (route == "binned")
        rc.reset_launches()
        got += [step() for _ in range(3)]
        assert rc.GRAPHS["captures"] == 1, rc.GRAPHS
        assert rc.GRAPHS["forward_replays"] == rc.GRAPHS["backward_replays"] == 2, rc.GRAPHS
        fims += [index_map() for _ in range(3)]
    assert want_images[0].sum() == 0 and want_images[1].sum() > 0
    assert float(want[0].abs().max()) == 0 and float(want[1].abs().max()) > 0
    for images, g in got:
        assert torch.equal(images, want_images)
        torch.testing.assert_close(g, want, rtol=0, atol=1e-4 * float(want.abs().max()))
        assert float(g[0].abs().max()) == 0
    for fim in fims:
        assert torch.equal(fim, want_fim)


def test_caller_capture_of_a_binned_step_without_warm_up_raises(cuda, fresh_cache):
    """A binned render inside the caller's capture with no eager run of the
    same render kept raises, and reads nothing back."""
    r, v, faces, _ = _graph_scene("bench", cuda)
    x = v.clone().requires_grad_(True)
    with nr.eager():
        r.render_silhouettes(x, faces)        # warms the kernels and tables, tiled
    graph = torch.cuda.CUDAGraph()
    with rc.forced_route("binned"), pytest.raises(RuntimeError, match="before capturing"):
        with torch.cuda.graph(graph):
            r.render_silhouettes(x, faces)


# the sharded entry's chains and compute_face_index_map's graphs


def _sharded_turns(shape, image_size, scene):
    """One rank of a ``shape`` mesh on the card: for silhouettes and lit
    RGBA, the eager sharded step (``nr.eager()``) and four steps through
    the compiled core (the first eager, the second capturing the chain, the
    later ones replaying it): each step's images and gradients, the graph
    counters, and the kernels launched eagerly in the last step."""
    from neural_renderer_v2_pytorch_tpu_torch import parallel

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = parallel.make_mesh(*shape)
    ndc, f, vt, ft, tex, lights = scene
    faces = torch.tensor(f, device=dev)
    cls = {"ambient": nr.AmbientLight, "directional": nr.DirectionalLight,
           "specular": nr.SpecularLight}
    hp = nr.RasterizeHyperparam(image_size=image_size)
    out = {}
    for entry in ("silhouettes", "rgba"):
        def step():
            x = torch.tensor(ndc, device=dev, requires_grad=True)
            grads = {"vertices": x}
            params = None
            if entry == "rgba":
                t = torch.tensor(tex, device=dev, requires_grad=True)
                ls = tuple(cls[k](**{n: torch.tensor(a, device=dev, requires_grad=n == "color")
                                     for n, a in arrays.items()}) for k, arrays in lights)
                grads.update(textures=t, **{f"light{i}": l.color for i, l in enumerate(ls)})
                params = nr.RasterizeParam(vertices_textures=torch.tensor(vt, device=dev),
                                           faces_textures=torch.tensor(ft, device=dev),
                                           textures=t, texture_size=2, lights=ls)
            images = getattr(parallel, f"rasterize_{entry}_sharded")(x, faces, params, hp,
                                                                     mesh=mesh)
            torch.sum(images * images).backward()
            return images.detach().cpu().numpy(), {k: v.grad.cpu().numpy()
                                                   for k, v in grads.items()}

        with nr.eager():
            want = step()
        # each entry from an empty cache: the face fold's own
        # compute_face_index_map signature is the same for both entries
        graphs._entries.clear()
        rc.reset_launches()
        steps = [step() for _ in range(3)]
        counted = dict(rc.GRAPHS)
        rc.reset_launches()
        steps.append(step())
        out[entry] = dict(want=want, steps=steps, graphs=counted,
                          replay_graphs=dict(rc.GRAPHS),
                          replay_launches={k: n for k, n in rc.LAUNCHES.items() if n})
    return out


@pytest.mark.parametrize("shape,image_size", [((1, 2, 1), 64), ((1, 1, 2), 64),
                                              ((1, 8, 1), 12)])
def test_sharded_chain_replays_the_eager_sharded_step(cuda, shape, image_size):
    """Gloo ranks share the card on a row axis (2 bands; 8 bands of 4 rows
    at 12^2 AA, the last two empty) or a face axis of 2: the compiled
    core's chain of graphs (captured at the second call, replayed from
    then on, the collectives run between the replays) gives the eager
    sharded step's images, its gradients within 1e-4 of their largest
    magnitude and the same bits on every rank; a replayed step launches no
    kernel eagerly."""
    from neural_renderer_v2_pytorch_tpu_torch import parallel

    v, f, vt, ft, tex = texel_scene(16, 12, 2)
    r = nr.Renderer("cpu")
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 20)
    ndc = r.transform_vertices(torch.tensor(v[None])).detach().numpy()
    scene = (ndc, f, vt, ft, tex, lit_light_arrays())
    ranks = parallel.run_ranks(_sharded_turns, int(np.prod(shape)), (shape, image_size, scene),
                               device="cuda", backend="gloo", timeout=240.0)
    for entry in ("silhouettes", "rgba"):
        for rank in ranks:
            got = rank[entry]
            want_images, want = got["want"]
            for step, (images, grads) in enumerate(got["steps"]):
                assert np.array_equal(images, want_images)
                for k, g in grads.items():
                    assert np.abs(want[k]).max() > 0, k
                    np.testing.assert_allclose(g, want[k], rtol=0,
                                               atol=1e-4 * np.abs(want[k]).max())
                    # one all-reduce hands every rank the same bits
                    assert np.array_equal(g, ranks[0][entry]["steps"][step][1][k])
            assert got["graphs"]["captures"] == 1, got["graphs"]
            assert got["graphs"]["forward_replays"] == 2 == got["graphs"]["backward_replays"]
            assert got["replay_graphs"]["forward_replays"] == 1, got["replay_graphs"]
            assert got["replay_launches"] == {}, got["replay_launches"]


# the sharded entry across cards: one rank per card over NCCL


def _nccl_rank(ndc, f, shape, image_size, anti_aliasing):
    """One rank of a ``shape`` mesh, one rank per card (NCCL): the
    single-device silhouettes step on this rank's card, then three sharded
    steps through the compiled core (the first eager, the second capturing
    the chain, the third replaying it).  Returns each step's images and
    vertex gradient, the backend and the chain's graphs and collectives."""
    import torch.distributed as dist

    from neural_renderer_v2_pytorch_tpu_torch import parallel

    dev = torch.device("cuda", torch.cuda.current_device())
    faces = torch.tensor(f, device=dev)
    hp = nr.RasterizeHyperparam(image_size=image_size, anti_aliasing=anti_aliasing)
    mesh = parallel.make_mesh(*shape)
    w = torch.rand((1, image_size, image_size), generator=torch.Generator().manual_seed(0))
    w = w.to(dev)

    def step(m=None):
        x = torch.tensor(ndc, device=dev, requires_grad=True)
        if m is None:
            im = nr.rasterize_silhouettes(x, faces, None, hp)
        else:
            im = parallel.rasterize_silhouettes_sharded(x, faces, None, hp, mesh=m)
        torch.sum(im * w).backward()
        return im.detach().cpu().numpy(), x.grad.cpu().numpy()

    want = step()
    calls = [step(mesh) for _ in range(3)]
    (chain,) = graphs.kept_graphs(faces)
    return dict(want=want, calls=calls, backend=dist.get_backend(),
                segments={k: len(v) for k, v in chain.segments.items()}, inline=chain.inline)


@pytest.mark.parametrize("name", ["bench-tile2", "scale-face2"])
def test_nccl_chain_across_two_cards_matches_one_card(cuda, name):
    """Two ranks, one per card, over NCCL: bench's torus over two row bands
    (256^2 AA) and scale's 81,920-face icosphere over two face ranges
    (512^2).  Every call, eager, capturing and replayed, gives the
    single-device images, its gradient within 1e-5 of the largest
    magnitude and rank 0's bits; the chain is one forward and one backward
    graph with every collective inside."""
    from neural_renderer_v2_pytorch_tpu_torch import parallel

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (one rank per card over NCCL)")
    v, f = torus(40, 32) if name == "bench-tile2" else icosphere(6)
    shape, size, aa = ((1, 2, 1), 256, True) if name == "bench-tile2" else ((1, 1, 2), 512, False)
    r = nr.Renderer("cpu")
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
    ndc = r.transform_vertices(torch.tensor(v[None])).detach().numpy()
    ranks = parallel.run_ranks(_nccl_rank, 2, (ndc, f, shape, size, aa), device="cuda",
                               timeout=240.0)
    for got in ranks:
        assert got["backend"] == "nccl"
        want_images, want = got["want"]
        assert np.abs(want).max() > 0
        for call, (images, grad) in enumerate(got["calls"]):
            assert np.array_equal(images, want_images)
            np.testing.assert_allclose(grad, want, rtol=0, atol=1e-5 * np.abs(want).max())
            assert np.array_equal(grad, ranks[0]["calls"][call][1])
        assert got["segments"] == {"forward": 1, "backward": 1}
        face = name == "scale-face2"
        assert got["inline"] == {"forward": ["face_all_gather"] * 2 * face
                                 + ["image_all_gather"] * (not face),
                                 "backward": ["halo_exchange"] * (not face)
                                 + ["grad_all_reduce"]}


def _index_graphs():
    return [g for (record, _), kept in graphs._entries.items() if record is graphs.INDEX_MAPS
            for g in kept]


@pytest.mark.parametrize("mode", ["tiled", "binned"])
def test_index_map_replays_its_graph_to_the_eager_bits(cuda, fresh_cache, mode):
    """compute_face_index_map on the card: the first call eager, the second
    captures a forward graph (K2D, or K7 capped and K8's id/depth form),
    every later call replays it; ids and depth bit-equal to the eager
    entry's, windows too, and fresh tensors each call."""
    rng = np.random.RandomState(9)
    fv = rng.uniform(-1, 1, (2, 300, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    x = torch.tensor(fv, device=cuda)
    for window in ((0, None), (24, 40)):
        kw = dict(row_start=window[0], num_rows=window[1], return_depth=True, mode=mode)
        with nr.eager():
            want = nr.compute_face_index_map(x, 100, **kw)
        rc.reset_launches()
        got = [nr.compute_face_index_map(x, 100, **kw) for _ in range(4)]
        assert rc.GRAPHS["captures"] == 1 and rc.GRAPHS["forward_replays"] == 3, rc.GRAPHS
        for index, depth in got:
            assert torch.equal(index, want[0]) and torch.equal(depth, want[1])
        assert got[2][0].data_ptr() != got[3][0].data_ptr()
        kernel = "resolve_depth" if mode == "tiled" else "resolve_binned_depth"
        graph = _index_graphs()[-1]
        assert graph.launches["forward"].get(kernel) == 1, graph.launches
        assert graph.launches["forward"].get("bin_faces", 0) == (mode == "binned")
        moved = nr.compute_face_index_map(x * 1.01, 100, **kw)
        with nr.eager():
            assert torch.equal(moved[0], nr.compute_face_index_map(x * 1.01, 100, **kw)[0])


def test_index_map_overflow_recaptures(cuda, fresh_cache):
    """A binned compute_face_index_map graph captured with a quarter of its
    pair total's slots gives the eager bits over overflow bins, reports them
    once its replay has finished, and the next call captures anew at twice
    the capacity."""
    rng = np.random.RandomState(11)
    fv = rng.uniform(-1, 1, (1, 400, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    x = torch.tensor(fv, device=cuda)
    kw = dict(return_depth=True, mode="binned")
    with nr.eager():
        want = nr.compute_face_index_map(x, 128, **kw)
    rc.reset_launches()
    nr.compute_face_index_map(x, 128, **kw)                     # eager, keeps the total
    total = graphs.INDEX_MAPS.bin_totals[((1, 3, 3, 400), 128, 0, None, True)]
    with graphs.forced_capacity(total // 4):
        got = nr.compute_face_index_map(x, 128, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    (graph,) = _index_graphs()
    assert graph.capacities == [total // 4] and graph.overflowed() > 0
    got = nr.compute_face_index_map(x, 128, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rc.GRAPHS["overflow_recaptures"] == 1 and rc.GRAPHS["captures"] == 2
    (again,) = _index_graphs()
    assert again is not graph and again.capacities[0] >= 2 * (total // 4)
    nr.compute_face_index_map(x, 128, **kw)
    torch.cuda.synchronize()
    assert again.overflowed() == 0


def test_bench_chained_step_equals_eager(cuda, fresh_cache):
    """The bench's whole step captured by its caller: a replay gives the
    eager step's images and gradients within 1e-4, and three chained
    replays (each on the last one's update) the vertices of three eager
    steps, within 1e-4 of how far they moved and their float32 rounding."""
    case = bench.scene(cuda).case("bench")
    with nr.eager():
        want = case.step()
    whole = steps.CallerGraph(case)
    steps.check_against("bench chained step", whole(), want)
    assert whole.launches == {"gather_faces3": 1, "resolve_xy": 1,
                              "scatter_pixels_to_faces": 1, "scatter_faces_to_vertices": 1,
                              "nmr_planes": 1, "nmr_planes_vjp": 1, "nmr_coordinate_grad": 1}
    whole.reset()
    for _ in range(3):
        whole.graph.replay()
    with nr.eager():
        (chained,), _, _ = steps.run_chain(case, 3)
    start = case.values[0]
    assert not torch.equal(whole.leaves[0].detach(), start)
    moved = float((chained - start).abs().max())
    # each update rounds to the vertices' float32 spacing
    spacing = 3 * torch.finfo(torch.float32).eps * float(start.abs().max())
    assert float((whole.leaves[0].detach() - chained).abs().max()) <= 1e-4 * moved + spacing


def test_bench_prints_its_json_line(cuda, fresh_cache, monkeypatch, capsys):
    monkeypatch.setenv("NR_BENCH_ITERS", "5")
    assert bench.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "device", "power_limit",
                          "forms", "faces"]
    assert line["unit"] == "pixels/s" and line["value"] > 0 and line["faces"] == 2560
    assert line["device"] and line["power_limit"].endswith("W")
    assert line["vs_baseline"] is None or line["vs_baseline"] > 0
    forms = line["forms"]
    assert len(forms["whole_cycles_ms"]) == bench.CYCLES and forms["iters"] == 5
    assert 0 < forms["whole_ms"] < forms["eager_ms"]
