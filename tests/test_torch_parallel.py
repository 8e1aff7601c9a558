"""The PyTorch port's sharded rendering (``parallel/``) against the port's
single-device render and the JAX package's sharded render.

The port's ranks are gloo processes on the CPU (``parallel.run_ranks``, one
spawn per mesh shape, each running every configuration of its shape).
They import no JAX: this module imports it inside the test functions only,
since each spawned rank imports the module to find its body.  The JAX
oracle runs in the test process on ``conftest.py``'s 8 virtual CPU devices.

Tolerances, against the port's single-device render: index maps and
images equal, gradients within 1e-5 of the largest magnitude (the ranks'
contributions are summed in another grouping).  Against the JAX package's
sharded render on the same mesh: index maps and silhouettes equal, RGB and
depth within 3e-5 and gradients within 1e-4 of the largest magnitude, the
JAX package's own sharded-vs-single bounds (tests/test_parallel.py): its
jit contracts multiply-adds.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu_torch as tnr
from neural_renderer_v2_pytorch_tpu_torch import parallel
from neural_renderer_v2_pytorch_tpu_torch.ops import differentiation as nmr
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import texel_scene

SPAWN_TIMEOUT = 120.0       # seconds for one spawn of ranks, each collective included
LIGHTS = ("directional", "ambient", "specular")

Config = collections.namedtuple("Config", "shape entry image_size anti_aliasing backgrounds",
                                defaults=(False,))
CONFIGS = {
    "face2-silhouettes": Config((1, 1, 2), "silhouettes", 64, True),
    "face2-lit": Config((1, 1, 2), "rgba", 64, True),
    "face2-depth": Config((1, 1, 2), "depth", 64, True),
    "tile2-silhouettes": Config((1, 2, 1), "silhouettes", 64, True),
    # 33 rows over 2 bands of 17: the second runs one row past the bottom
    "tile2-uneven": Config((1, 2, 1), "silhouettes", 33, False),
    # the blend reads each band's mirrored rows of a seeded background,
    # whose gradient is summed over the ranks like the other inputs'
    "tile2-backgrounds": Config((1, 2, 1), "rgb", 64, True, True),
    "all-axes-lit": Config((2, 2, 2), "rgba", 64, True),
    # data > 1 with backgrounds: each data cell blends its own images' band
    # of mirrored background rows (in the 8-rank spawn)
    "all-axes-backgrounds": Config((2, 2, 2), "rgb", 64, True, True),
    # 66 rows over 4 bands of 18 (even under AA, so that no 2x2 pool
    # straddles two bands): the last has 12, six rows past the bottom
    # cropped; the JAX package splits them as 4 x 17 (tests/test_parallel.py:330)
    "tile4-face2-uneven": Config((1, 4, 2), "rgba", 33, True),
    # 24 rows over 8 bands of 4: the last two bands lie wholly past the
    # bottom and are empty, yet join every collective
    "tile8-empty": Config((1, 8, 1), "silhouettes", 12, True),
}


def _spawn_of(name):
    """The spawn that runs a config: its mesh shape, or 8 for the two shapes
    of 8 ranks, which share one."""
    return 8 if np.prod(CONFIGS[name].shape) == 8 else CONFIGS[name].shape


# --- the scene (numpy; NDC through the JAX camera in the test process) ---


def _scene_arrays(image_size, anti_aliasing):
    """torus(16, 12) (384 faces) with create_textures texels (ts = 2), two
    views, three lights and a loss weight per image, as numpy arrays."""
    import jax.numpy as jnp

    import neural_renderer_v2_pytorch_tpu as jnr

    v, f, vt, ft, tex = texel_scene(16, 12, 2)
    ndc = []
    for azimuth in (20, 65):
        r = jnr.Renderer()
        r.viewpoints = jnr.get_points_from_angles(2.732, 30, azimuth)
        ndc.append(np.asarray(r.transform_vertices(jnp.asarray(v[None])))[0])
    rng = np.random.RandomState(image_size)
    size = image_size
    render_size = image_size * (2 if anti_aliasing else 1)
    return {
        "vertices": np.stack(ndc), "faces": f, "vertices_textures": np.repeat(vt, 2, 0),
        "faces_textures": ft, "textures": rng.rand(2, *tex.shape[1:]).astype(np.float32),
        "directional_color": rng.uniform(0.3, 0.7, (2, 3)).astype(np.float32),
        "directional_direction": rng.uniform(-1, 1, (2, 3)).astype(np.float32),
        "ambient_color": rng.uniform(0.2, 0.4, (2, 3)).astype(np.float32),
        "specular_color": rng.uniform(0.1, 0.3, (2, 3)).astype(np.float32),
        "weight": rng.rand(2, 5, size, size).astype(np.float32),
        "backgrounds": rng.rand(2, 3, render_size, render_size).astype(np.float32),
        "render_size": render_size,
    }


def _tie_arrays():
    """Faces 0 and 4 coincide 5e-5 apart in depth (inside the 1e-4 band),
    with zero faces between, so that over two ranks they fall on different
    ranks (tests/test_parallel.py:173-201): face 0 must win."""
    tri = np.array([[[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0]]], np.float32)
    fv = np.concatenate([tri, np.zeros((3, 3, 3), np.float32), tri + [0, 0, 5e-5]], 0)
    return fv.reshape(1, -1, 3).astype(np.float32), np.arange(15, dtype=np.int32).reshape(5, 3)


# --- the port, in a rank or in this process -------------------------------


def _leaf_names(arrays, cfg):
    """The inputs that take gradients."""
    names = ["vertices"]
    if cfg.entry in ("rgba", "rgb"):
        names += ["vertices_textures", "textures"] + [
            k for k in arrays if k.split("_")[0] in LIGHTS]
    if cfg.backgrounds:
        names.append("backgrounds")
    return names


def _port_inputs(arrays, cfg):
    """(leaves {name: tensor requiring grad}, vertices, faces, params)."""
    t = {k: torch.tensor(arrays[k], requires_grad=True) for k in _leaf_names(arrays, cfg)}
    params = None
    if cfg.entry in ("rgba", "rgb"):
        params = tnr.RasterizeParam(
            vertices_textures=t["vertices_textures"],
            faces_textures=torch.tensor(arrays["faces_textures"]), textures=t["textures"],
            texture_size=2, backgrounds=t.get("backgrounds"), lights=(
                tnr.DirectionalLight(t["directional_color"], t["directional_direction"]),
                tnr.AmbientLight(t["ambient_color"]), tnr.SpecularLight(t["specular_color"])),
        )
    return t, t["vertices"], torch.tensor(arrays["faces"]), params


def _weighted_sum(images, weight):
    w = torch.tensor(weight)
    w = w[:, :images.shape[1]] if images.ndim == 4 else w[:, 0]
    return torch.sum(images * w)


def _port_render(cfg, arrays, mesh=None):
    """(images, {leaf: gradient}) of sum(images * weight), sharded over
    ``mesh`` or on one device."""
    t, x, f, params = _port_inputs(arrays, cfg)
    hp = tnr.RasterizeHyperparam(image_size=cfg.image_size, anti_aliasing=cfg.anti_aliasing)
    if mesh is None:
        images = getattr(tnr, "rasterize_" + cfg.entry)(x, f, params, hp)
    else:
        images = getattr(parallel, f"rasterize_{cfg.entry}_sharded")(x, f, params, hp, mesh=mesh)
    _weighted_sum(images, arrays["weight"]).backward()
    return images.detach().numpy(), {k: v.grad.numpy() for k, v in t.items()}


def _band_index_map(arrays, cfg, mesh):
    """This rank's band of the index map over its batch slice."""
    x = torch.tensor(arrays["vertices"])
    bl = x.shape[0] // mesh.shape["data"]
    d, t = mesh.coords["data"], mesh.coords["tile"]
    fv = x[d * bl:(d + 1) * bl][:, torch.tensor(arrays["faces"]).long()]
    render_size = arrays["render_size"]
    rows = parallel.band_rows(cfg.image_size, cfg.anti_aliasing, mesh.shape["tile"])
    window = dict(row_start=t * rows, num_rows=rows)
    if mesh.shape["face"] > 1:
        return parallel.compute_face_index_map_face_sharded(fv, render_size,
                                                            group=mesh.groups["face"], **window)
    return tnr.compute_face_index_map(fv, render_size, **window)


def _rank_body(jobs):
    """One rank's share of a spawn: every (name, arrays) job on its mesh.
    Returns {name: results} and the tie scene's when it is a job."""
    meshes, out = {}, {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = parallel.make_mesh(*shape)
        return meshes[shape]

    for name, arrays in jobs:
        if name == "tie":
            mesh = mesh_of((1, 1, 2))
            x, f = (torch.tensor(a) for a in arrays)
            hp = tnr.RasterizeHyperparam(image_size=32, anti_aliasing=False)
            out[name] = dict(
                image=parallel.rasterize_silhouettes_sharded(x, f, None, hp, mesh=mesh).numpy(),
                index=parallel.compute_face_index_map_face_sharded(x[:, f.long()], 32).numpy())
            continue
        cfg = CONFIGS[name]
        mesh = mesh_of(cfg.shape)
        parallel.reset_collectives()
        rc.reset_launches()
        t, x, f, params = _port_inputs(arrays, cfg)
        hp = tnr.RasterizeHyperparam(image_size=cfg.image_size, anti_aliasing=cfg.anti_aliasing)
        images = getattr(parallel, f"rasterize_{cfg.entry}_sharded")(x, f, params, hp, mesh=mesh)
        forward = dict(parallel.COLLECTIVES)
        with _nmr_inputs_seen() as seen:
            _weighted_sum(images, arrays["weight"]).backward()
        out[name] = dict(
            image=images.detach().numpy(), grads={k: v.grad.numpy() for k, v in t.items()},
            forward=forward, step=dict(parallel.COLLECTIVES), launches=dict(rc.LAUNCHES),
            coords=mesh.coords, index=_band_index_map(arrays, cfg, mesh).numpy(), nmr=seen)
    return out


@contextlib.contextmanager
def _nmr_inputs_seen():
    """The shapes of the images each NMR backward's coordinate gradient
    reads (``band_coordinate_grad``, the whole image's and a band's), in a
    list filled while the block runs."""
    real, seen = nmr.band_coordinate_grad, []

    def spy(images, *args):
        seen.append(tuple(images.shape))
        return real(images, *args)

    nmr.band_coordinate_grad = spy
    try:
        yield seen
    finally:
        nmr.band_coordinate_grad = real


# --- the JAX package's sharded render (this process) ----------------------


def _jax_sharded(cfg, arrays):
    """(images, {leaf: gradient}, index map) from the JAX package's sharded
    entry and face-sharded resolve on the same mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import neural_renderer_v2_pytorch_tpu as jnr
    from neural_renderer_v2_pytorch_tpu import parallel as jpar
    from neural_renderer_v2_pytorch_tpu.ops.rasterize import RasterizeHyperparam, RasterizeParam
    from neural_renderer_v2_pytorch_tpu.ops.resolve import compute_face_index_map
    from neural_renderer_v2_pytorch_tpu.parallel.render import _shard_map

    mesh = jpar.make_mesh(*cfg.shape)
    hp = RasterizeHyperparam(image_size=cfg.image_size, anti_aliasing=cfg.anti_aliasing)
    fn = getattr(jpar, f"rasterize_{cfg.entry}_sharded")
    faces = jnp.asarray(arrays["faces"])
    names = _leaf_names(arrays, cfg)

    def loss(leaves):
        params = None
        if cfg.entry in ("rgba", "rgb"):
            params = RasterizeParam(
                vertices_textures=leaves["vertices_textures"],
                faces_textures=jnp.asarray(arrays["faces_textures"]),
                textures=leaves["textures"], texture_size=2,
                backgrounds=leaves.get("backgrounds"), lights=(
                    jnr.DirectionalLight(leaves["directional_color"],
                                         leaves["directional_direction"]),
                    jnr.AmbientLight(leaves["ambient_color"]),
                    jnr.SpecularLight(leaves["specular_color"])))
        images = fn(leaves["vertices"], faces, params, hp, mesh=mesh)
        w = arrays["weight"][:, :images.shape[1]] if images.ndim == 4 else arrays["weight"][:, 0]
        return jnp.sum(images * w), images

    (_, images), grads = jax.value_and_grad(loss, has_aux=True)(
        {k: jnp.asarray(arrays[k]) for k in names})
    S, (_, n_tile, n_face) = arrays["render_size"], cfg.shape
    rows = -(-S // n_tile)

    def band(fv):
        window = dict(row_start=jax.lax.axis_index("tile") * rows, num_rows=rows)
        if n_face > 1:
            return jpar.compute_face_index_map_face_sharded(fv, S, **window)
        return compute_face_index_map(fv, S, **window)

    fv = jnp.asarray(arrays["vertices"])[:, faces]
    index = _shard_map(band, mesh, (P("data"),), P("data", "tile"))(fv)
    return (np.asarray(images), {k: np.asarray(v) for k, v in grads.items()},
            np.asarray(index)[:, :S])


# --- fixtures: one spawn per mesh shape -----------------------------------


@pytest.fixture(scope="module")
def scenes():
    keys = {(c.image_size, c.anti_aliasing) for c in CONFIGS.values()}
    return {k: _scene_arrays(*k) for k in keys}


def _arrays(scenes, name):
    cfg = CONFIGS[name]
    return scenes[cfg.image_size, cfg.anti_aliasing]


@pytest.fixture(scope="module")
def spawned(scenes):
    """spawn -> per-rank results of every config in it (and the tie scene's
    in the two-rank face spawn), run once per module."""
    cache = {}

    def get(spawn):
        if spawn not in cache:
            jobs = [(n, _arrays(scenes, n)) for n in CONFIGS if _spawn_of(n) == spawn]
            if spawn == (1, 1, 2):
                jobs.append(("tie", _tie_arrays()))
            world = spawn if isinstance(spawn, int) else int(np.prod(spawn))
            cache[spawn] = parallel.run_ranks(_rank_body, world, (jobs,), device="cpu",
                                              timeout=SPAWN_TIMEOUT)
        return cache[spawn]

    return get


def _ranks(spawned, name):
    return [r[name] for r in spawned(_spawn_of(name))]


def _full_index_map(ranks, shape, render_size):
    """The index map assembled from the ranks' bands (checked equal across
    the face axis), cropped to the image."""
    _, n_tile, _ = shape
    bands = {}
    for r in ranks:
        key = (r["coords"]["data"], r["coords"]["tile"])
        if key in bands:
            np.testing.assert_array_equal(r["index"], bands[key])
        bands[key] = r["index"]
    n_data = 1 + max(d for d, _ in bands)
    rows = np.concatenate([np.concatenate([bands[d, t] for t in range(n_tile)], 1)
                           for d in range(n_data)], 0)
    return rows[:, :render_size]


@pytest.fixture(scope="module")
def single(scenes):
    """The port's single-device render and index map of each config."""
    out = {}
    for name, cfg in CONFIGS.items():
        arrays = _arrays(scenes, name)
        x = torch.tensor(arrays["vertices"])
        index = tnr.compute_face_index_map(x[:, torch.tensor(arrays["faces"]).long()],
                                           arrays["render_size"]).numpy()
        out[name] = (*_port_render(cfg, arrays), index)
    return out


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


# --- tests ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_render_matches_single_device(spawned, single, name):
    cfg = CONFIGS[name]
    ranks = _ranks(spawned, name)
    image, grads, index = single[name]
    assert (index >= 0).any() and np.abs(image).max() > 0
    np.testing.assert_array_equal(
        _full_index_map(ranks, cfg.shape, _arrays_size(name)), index)
    for r in ranks:                      # every rank returns the global images
        np.testing.assert_array_equal(r["image"], image)
        for k, g in grads.items():
            assert np.abs(g).max() > 0, k
            _close(r["grads"][k], g, 1e-5)
            # the same bits on every rank: replicas that differ drift apart
            np.testing.assert_array_equal(r["grads"][k], ranks[0]["grads"][k])


def _arrays_size(name):
    cfg = CONFIGS[name]
    return cfg.image_size * (2 if cfg.anti_aliasing else 1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_render_matches_jax_sharded(spawned, scenes, name):
    cfg = CONFIGS[name]
    ranks = _ranks(spawned, name)
    images, grads, index = _jax_sharded(cfg, _arrays(scenes, name))
    np.testing.assert_array_equal(_full_index_map(ranks, cfg.shape, _arrays_size(name)), index)
    if cfg.entry == "silhouettes":
        np.testing.assert_array_equal(ranks[0]["image"], images)
    else:
        np.testing.assert_allclose(ranks[0]["image"], images, rtol=0, atol=3e-5)
    for k, g in grads.items():
        _close(ranks[0]["grads"][k], g, 1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_collective_census(spawned, name):
    """Per step: two face all-gathers (depth, id) when face > 1, none with
    face = 1; one all-gather of the finished images when the mesh has more
    than one (data, tile) cell; in the backward, one halo exchange when
    tile > 1 and one gradient all-reduce, over every rank.  No collective
    carries the render-size planes."""
    data, tile, face = CONFIGS[name].shape
    for r in _ranks(spawned, name):
        assert r["forward"] == {"face_all_gather": 2 * (face > 1),
                                "image_all_gather": int(data * tile > 1),
                                "halo_exchange": 0, "grad_all_reduce": 0}
        assert r["step"] == dict(r["forward"], halo_exchange=int(tile > 1), grad_all_reduce=1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_nmr_backward_reads_its_band(spawned, name):
    """Each rank's NMR backward reads its batch slice of its band's rows of
    the images (the whole image only where tile = 1), and an empty band's
    none."""
    cfg = CONFIGS[name]
    data, tile, _ = cfg.shape
    size = _arrays_size(name)
    rows = parallel.band_rows(cfg.image_size, cfg.anti_aliasing, tile)
    channels = {"silhouettes": 1, "depth": 1, "rgb": 3, "rgba": 4}[cfg.entry]
    seen_rows = []
    for r in _ranks(spawned, name):
        real = max(0, min(rows, size - r["coords"]["tile"] * rows))
        assert r["nmr"] == ([(2 // data, channels, real, size)] if real else [])
        seen_rows.append(real)
    assert max(seen_rows) < size or tile == 1
    if name == "tile8-empty":
        assert seen_rows == [4, 4, 4, 4, 4, 4, 0, 0]


@pytest.mark.parametrize("name", ["face2-lit", "all-axes-lit", "tile2-silhouettes"])
def test_sharded_path_runs_its_kernels_plain_versions(spawned, name):
    """On the CPU every wrapper takes its plain version: nothing launches,
    on the face path (the winner gather) or off it."""
    for r in _ranks(spawned, name):
        assert all(n == 0 for n in r["launches"].values()), r["launches"]


def test_face_sharded_cross_shard_tie(spawned):
    x, f = _tie_arrays()
    hp = tnr.RasterizeHyperparam(image_size=32, anti_aliasing=False)
    single = tnr.rasterize_silhouettes(torch.tensor(x), torch.tensor(f), None, hp).numpy()
    for r in spawned((1, 1, 2)):
        assert set(np.unique(r["tie"]["index"])) == {-1, 0}      # face 4 never displaces 0
        np.testing.assert_array_equal(r["tie"]["image"], single)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_ordered_z_combine_matches_jax(n):
    import jax.numpy as jnp

    from neural_renderer_v2_pytorch_tpu.parallel.faces import ordered_z_combine

    rng = np.random.RandomState(n)
    depths = rng.uniform(1.0, 1.001, (n, 2, 16, 16)).astype(np.float32)
    depths[1:, :, :4] = depths[:1, :, :4] - 5e-5           # within-band ties
    depths[-1, :, 4:6] = 100.0                             # background
    indices = rng.randint(-1, 50, (n, 2, 16, 16)).astype(np.int32)
    want = ordered_z_combine((jnp.asarray(depths), jnp.asarray(indices)))
    got = parallel.ordered_z_combine((torch.tensor(depths), torch.tensor(indices)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ordered_z_combine_tolerance_band():
    """A later rank's winner within the band does not displace the earlier
    one (tests/test_parallel.py:204-215)."""
    depths = torch.tensor([[1.0, 1.0], [1.0 - 5e-5, 0.5]])
    indices = torch.tensor([[7, 7], [9, 9]], dtype=torch.int32)
    d, i = parallel.ordered_z_combine((depths, indices))
    assert i.tolist() == [7, 9]
    np.testing.assert_allclose(d.numpy(), [1.0, 0.5])


@pytest.mark.parametrize("n,num_faces", [
    (8, None), (4, None), (2, None), (1, None), (8, 160_000), (8, 25_000), (8, 2_500),
    (4, 160_000), (2, 81_920), (2, 158_720), (2, 2_560), (8, 81_920),
])
def test_auto_mesh_shape_matches_jax(n, num_faces):
    from neural_renderer_v2_pytorch_tpu.parallel.mesh import auto_mesh

    from neural_renderer_v2_pytorch_tpu_torch.parallel.mesh import auto_mesh_shape
    from neural_renderer_v2_pytorch_tpu_torch.utils.convert import mesh_shape_from_jax

    want = mesh_shape_from_jax(auto_mesh(n, num_faces=num_faces))
    assert dict(zip(("data", "tile", "face"), auto_mesh_shape(n, num_faces))) == want


def test_initialize_contract(monkeypatch):
    """Without a cluster in the environment, no arguments return False; a
    device the port does not run on, or CUDA where there is none, raises."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.distributed.initialize() is False
    with pytest.raises(ValueError):
        parallel.distributed.initialize("file:///nonexistent", 1, 0, device="tpu")
    with pytest.raises(ValueError):
        parallel.distributed.initialize("file:///nonexistent", 1, 0, "nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            parallel.distributed.initialize("file:///nonexistent", 1, 0)
    with pytest.raises(RuntimeError):
        parallel.make_mesh(1, 1, 1)


def _fail_on_rank_one():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.barrier()                         # rank 0 waits for a rank that is gone


def _fail_on_rank_one_and_exit_last():
    import threading
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        # a thread the interpreter waits for at exit: rank 0, whose barrier
        # breaks when this rank leaves the group, exits first
        threading.Thread(target=time.sleep, args=(3,)).start()
        raise ValueError("rank one fails")
    dist.barrier()


def _hang():
    import time

    time.sleep(60)


def test_run_ranks_raises_when_a_rank_fails_or_overruns():
    with pytest.raises(RuntimeError, match="rank one fails"):
        parallel.run_ranks(_fail_on_rank_one, 2, device="cpu", timeout=30.0)
    with pytest.raises(TimeoutError):
        parallel.run_ranks(_hang, 2, device="cpu", timeout=5.0)


def test_run_ranks_reports_a_failed_rank_that_exits_last():
    """The rank that failed first is reported even when the rank it broke
    exits before it."""
    with pytest.raises(RuntimeError, match="rank one fails"):
        parallel.run_ranks(_fail_on_rank_one_and_exit_last, 2, device="cpu", timeout=30.0)


def test_mesh_shape_from_jax_fills_the_face_axis():
    from neural_renderer_v2_pytorch_tpu.parallel import make_mesh

    from neural_renderer_v2_pytorch_tpu_torch.utils.convert import mesh_shape_from_jax

    assert mesh_shape_from_jax(make_mesh(2, 4)) == {"data": 2, "tile": 4, "face": 1}
    assert mesh_shape_from_jax(make_mesh(2, 2, 2)) == {"data": 2, "tile": 2, "face": 2}


def test_sharded_rejects_a_batch_the_data_axis_does_not_divide():
    mesh = parallel.Mesh({"data": 2, "tile": 1, "face": 1},
                         {"data": 0, "tile": 0, "face": 0}, {})
    x = torch.zeros(3, 4, 3)
    with pytest.raises(ValueError, match="does not divide"):
        parallel.rasterize_silhouettes_sharded(x, torch.zeros(1, 3, dtype=torch.int32),
                                               mesh=mesh)
