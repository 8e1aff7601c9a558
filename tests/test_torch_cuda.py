"""The port's hand-written CUDA kernels against their plain versions, on the
card.  Marked ``cuda``: each test skips without a CUDA device.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
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
    fvp = _soup_planar(nf, bs, nf, cuda)
    consts = rc.face_setup(fvp, draw_backside)
    assert torch.equal(consts, rc.face_setup_plain(fvp, draw_backside))
    got = rc.resolve_xy(consts, fvp, size, 0.1, 100.0)
    want = rc.resolve_xy_plain(consts, fvp, size, 0.1, 100.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
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
        im = nr.rasterize_silhouettes(x, torch.tensor(f, device=dev), None,
                                      nr.RasterizeHyperparam(image_size=64))
        torch.sum(im * im).backward()
        out.append((im.detach().cpu(), x.grad.cpu()))
    silhouette = ("face_setup", "resolve_xy", "scatter_pixels_to_faces",
                  "scatter_faces_to_vertices", "gather_faces3")
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
    consts = rc.face_setup(fvp, True)
    with pytest.raises(ValueError):
        rc.resolve_xy(consts, fvp.cpu(), 16, 0.1, 100.0)


@pytest.mark.parametrize("num_attrs", [0, 6, 27])
@pytest.mark.parametrize("bs,nf,size", [(2, 37, 64), (1, 300, 100)])
def test_resolve_latch_is_bit_exact(cuda, bs, nf, size, num_attrs):
    fvp = _soup_planar(nf + 1, bs, nf, cuda)
    consts = rc.face_setup(fvp, True)
    attrs = torch.randn((bs, nf, num_attrs), device=cuda)
    got = rc.resolve_latch(consts, fvp, attrs, size, 0.1, 100.0)
    want = rc.resolve_latch_plain(consts, fvp, attrs, size, 0.1, 100.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # its index and depth are K2's
    xy = rc.resolve_xy(consts, fvp, size, 0.1, 100.0)
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
        im = nr.rasterize_rgba(x, torch.tensor(f, device=dev), p,
                               nr.RasterizeHyperparam(image_size=64))
        torch.sum(im * im).backward()
        out.append((im.detach().cpu(), x.grad.cpu(), t.grad.cpu()))
    textured = ("face_setup", "resolve_latch", "scatter_pixels_to_faces",
                "scatter_faces_to_vertices", "gather_faces3")
    assert all(rc.LAUNCHES[n] == 1 for n in textured), rc.LAUNCHES
    assert rc.LAUNCHES["scatter_rows"] == (1 if scene == "atlas" else 0)
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=1e-5)
    for i in (1, 2):
        torch.testing.assert_close(out[1][i], out[0][i], rtol=0,
                                   atol=1e-4 * float(out[0][i].abs().max()))


@pytest.mark.parametrize("tile", rc.BIN_TILES)
@pytest.mark.parametrize("window", [(0, None), (40, 27)])
@pytest.mark.parametrize("bs,nf,size", [(2, 37, 64), (1, 300, 100), (3, 5, 17)])
def test_bin_faces_and_binned_resolve_are_bit_exact(cuda, bs, nf, size, window, tile):
    """K7's bins against their plain version, and each K8 form against its
    plain version and the tiled form, on ragged canvases and windows, at
    each tile K8 is built for."""
    row_start, num_rows = window
    if num_rows is not None and row_start + num_rows > size:
        row_start, num_rows = size // 3, size // 2
    fvp = _soup_planar(nf + 2, bs, nf, cuda)
    consts = rc.face_setup(fvp, True)
    attrs = torch.randn((bs, nf, 6), device=cuda)
    w = (row_start, num_rows)
    bins = rc.bin_faces(consts, size, *w, tile=tile)
    for g, p in zip(bins, rc.bin_faces_plain(consts, size, *w, tile=tile)):
        assert torch.equal(g, p)
    args = (size, 0.1, 100.0, *w)
    forms = [
        (rc.resolve_binned_xy(consts, fvp, bins, *args, tile=tile),
         rc.resolve_binned_xy_plain(consts, fvp, bins, *args, tile=tile),
         rc.resolve_xy(consts, fvp, *args)),
        (rc.resolve_binned_latch(consts, fvp, attrs, bins, *args, tile=tile),
         rc.resolve_binned_latch_plain(consts, fvp, attrs, bins, *args, tile=tile),
         rc.resolve_latch(consts, fvp, attrs, *args)),
        (rc.resolve_binned_depth(consts, bins, *args, tile=tile),
         rc.resolve_binned_depth_plain(consts, bins, *args, tile=tile),
         rc.resolve_depth(consts, *args)),
    ]
    for got, plain, tiled in forms:
        for g, p, t in zip(got, plain, tiled):
            assert torch.equal(g, p) and torch.equal(g, t)
    assert (forms[0][0][0] >= 0).any()


def test_compute_face_index_map_on_card_launches_kernels(cuda):
    """The id/depth entry runs K1 and a resolve kernel on the card (the
    route's), never the plain fold, and gives the CPU's result."""
    rng = np.random.RandomState(5)
    fv = rng.uniform(-1, 1, (2, 40, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    want = nr.compute_face_index_map(torch.tensor(fv), 64, return_depth=True)
    for mode, kernel in (("auto", "resolve_depth"), ("binned", "resolve_binned_depth")):
        rc.reset_launches()
        got = nr.compute_face_index_map(torch.tensor(fv, device=cuda), 64, return_depth=True,
                                        mode=mode)
        assert rc.LAUNCHES["face_setup"] == 1 and rc.LAUNCHES[kernel] == 1, rc.LAUNCHES
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
