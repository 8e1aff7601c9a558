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
import weakref

import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu_torch.ops import graphs
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import (
    atlas_scene,
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
    # the tiled route: K2 forms the face constants itself, so no K1
    silhouette = ("resolve_xy", "scatter_pixels_to_faces", "scatter_faces_to_vertices",
                  "gather_faces3")
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
    T = 5000
    g = torch.randn((2, 12, 4096), generator=gen, device=cuda)
    ids = torch.randint(-1, T, (2, 4096), generator=gen, device=cuda, dtype=torch.int32)
    got, want = rc.scatter_rows(g, ids, T), rc.scatter_rows_plain(g, ids, T)
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
    assert rc.LAUNCHES["scatter_rows"] == (1 if scene == "atlas" else 0)
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
        # seen from above (its axis is y), as chip_smoke.crowded_fvp
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
