"""Resolve of the PyTorch port (the plain versions of kernels K1 and K2)
against the JAX package, on identical NDC faces: exact.

Depth is compared with the JAX resolve run eagerly: under ``jit`` XLA
contracts ``zp``'s denominator into multiply-adds, which moves depths by a
few ulp (the index maps stay equal on these scenes, and are compared with
the jitted resolve too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu.ops import resolve as jres
from neural_renderer_v2_pytorch_tpu.ops.resolve_pallas import resolve_gather_pallas
from neural_renderer_v2_pytorch_tpu_torch.ops import gather_resolve as tgr
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve as tres
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda


def _soup(seed, bs, nf, z_min=0.1, duplicates=True):
    """Random overlapping triangle soup [bs, nf, 3, 3] with exact duplicates
    and a degenerate face (the pattern of test_resolve_pallas's fuzz)."""
    rng = np.random.RandomState(seed)
    fv = rng.uniform(-1, 1, (bs, nf, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + z_min
    if duplicates and nf > 4:
        fv[:, 1] = fv[:, 0]
        fv[:, 2, 1] = fv[:, 2, 0]
    return fv


def _planar(fv):
    return np.ascontiguousarray(fv.transpose(0, 3, 2, 1))


@pytest.mark.parametrize("draw_backside", [True, False])
def test_face_setup_plain_matches_jax_constants_and_kill_rule(draw_backside):
    fvp = _planar(_soup(0, 2, 37))
    consts = np.array(jres.face_constants_planar(jnp.asarray(fvp)))
    valid = np.abs(consts[:, 12]) >= np.float32(1e-8)
    if not draw_backside:
        valid &= ~np.asarray(jres.face_backside(tuple(jnp.asarray(consts[:, j]) for j in range(9))))
    for j, v in zip(range(13, 17), (4.0, -4.0, 4.0, -4.0)):
        consts[:, j] = np.where(valid, consts[:, j], np.float32(v))
    got = resolve_cuda.face_setup(torch.tensor(fvp), draw_backside).numpy()
    assert (~valid).any()
    np.testing.assert_array_equal(got, consts)


@pytest.mark.parametrize("draw_backside", [True, False])
@pytest.mark.parametrize("seed,bs,nf,size", [(0, 2, 37, 64), (1, 1, 101, 48), (2, 3, 3, 32)])
def test_index_map_matches_jax(seed, bs, nf, size, draw_backside):
    fv = _soup(seed, bs, nf)
    want = jres.compute_face_index_map(jnp.asarray(fv), size, draw_backside=draw_backside)
    with jax.disable_jit():
        eager, want_depth = jres.compute_face_index_map(
            jnp.asarray(fv), size, draw_backside=draw_backside, return_depth=True
        )
    got, depth = tgr.compute_face_index_map(
        torch.tensor(fv), size, draw_backside=draw_backside, return_depth=True
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    np.testing.assert_array_equal(depth.numpy(), np.asarray(want_depth))
    assert (np.asarray(want) >= 0).any()


@pytest.mark.parametrize("draw_backside", [True, False])
def test_resolve_xy_plain_matches_jax_pallas_latch(draw_backside):
    """Index map, depth and latched XY planes against the Pallas kernel
    (interpret mode) on the planar XY-latch path, odd face count."""
    fv = _soup(3, 2, 41)
    fvp = _planar(fv)
    size = 64
    index, coords, _ = resolve_gather_pallas(
        jnp.asarray(fvp), None, size, draw_backside=draw_backside,
        interpret=True, latch_z=False, planar_faces=True,
    )
    with jax.disable_jit():
        _, want_depth = jres.compute_face_index_map(
            jnp.asarray(fv), size, draw_backside=draw_backside, return_depth=True
        )
    t = torch.tensor(fvp)
    got_index, got_depth, got_coords = resolve_cuda.resolve_xy(t, draw_backside, size, 0.1,
                                                               100.0)
    np.testing.assert_array_equal(got_index.numpy(), np.asarray(index))
    np.testing.assert_array_equal(got_coords.numpy(), np.asarray(coords))
    np.testing.assert_array_equal(got_depth.numpy(), np.asarray(want_depth))


def test_weight_planes_match_jax():
    fv = _soup(4, 2, 29)
    size = 48
    fim = np.asarray(jres.compute_face_index_map(jnp.asarray(fv), size))
    safe = np.maximum(fim, 0)
    fvm = np.take_along_axis(
        fv.reshape(2, -1, 9), safe.reshape(2, -1, 1), axis=1
    ).reshape(2, size, size, 9).transpose(0, 3, 1, 2)
    fvm = np.where(fim[:, None] >= 0, fvm, 0).astype(np.float32)
    want = np.asarray(jres.weight_planes_from_gathered(jnp.asarray(fvm), jnp.asarray(fim), size))
    got = tres.weight_planes_from_gathered(torch.tensor(fvm), torch.tensor(fim), size).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrappers_take_plain_version_only_on_cpu():
    resolve_cuda.reset_launches()
    fvp = torch.tensor(_planar(_soup(5, 1, 9)))
    resolve_cuda.face_setup(fvp, True)
    assert all(n == 0 for n in resolve_cuda.LAUNCHES.values())
    with pytest.raises(ValueError):
        resolve_cuda.face_setup(fvp.to("meta"), True)
