"""Gradient scatters of the PyTorch port (the plain versions of kernels K3
and K4) and its two autograd Functions against the JAX package.

Tolerance 1e-4 of the largest magnitude: the JAX kernels split gradients
into bf16 halves (~2^-17 relative), and every implementation sums in its
own order (the hand kernels with atomics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu.ops import gather_resolve as jgr
from neural_renderer_v2_pytorch_tpu.ops.resolve import compute_face_index_map
from neural_renderer_v2_pytorch_tpu.ops.resolve_pallas import (
    scatter_slots3_pallas,
    scatter_to_faces_pallas,
)
from neural_renderer_v2_pytorch_tpu_torch.ops import gather_resolve as tgr
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import icosphere


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _soup_planar(seed, bs, nf):
    rng = np.random.RandomState(seed)
    fv = rng.uniform(-1, 1, (bs, nf, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    return np.ascontiguousarray(fv.transpose(0, 3, 2, 1)), fv


@pytest.mark.parametrize("D", [6, 9, 15, 27, 36])
def test_scatter_pixels_to_faces_matches_jax_kernel(D):
    fvp, fv = _soup_planar(0, 2, 57)
    fim = np.asarray(compute_face_index_map(jnp.asarray(fv), 48))
    g = np.random.RandomState(1).randn(2, D, 48, 48).astype(np.float32)
    want = np.asarray(scatter_to_faces_pallas(
        jnp.asarray(g), jnp.asarray(fim), 57, interpret=True, planar=True, planar_out=True
    ))
    got = resolve_cuda.scatter_pixels_to_faces(torch.tensor(g), torch.tensor(fim), 57)
    assert got.shape == (2, D, 57)
    _close(got.numpy(), want)


def test_scatter_faces_to_vertices_matches_jax_kernel():
    _, faces = icosphere(2)
    nv, nf = int(faces.max()) + 1, len(faces)
    g = np.random.RandomState(2).randn(2, 3, 3, nf).astype(np.float32)
    ids3 = jnp.broadcast_to(jnp.asarray(faces.T)[None], (2, 3, nf))
    want = np.asarray(scatter_slots3_pallas(jnp.asarray(g), ids3, nv, interpret=True))
    got = resolve_cuda.scatter_faces_to_vertices(torch.tensor(g), torch.tensor(faces), nv)
    _close(got.numpy(), want)


def test_gather_face_vertices_matches_jax_vjp():
    v, faces = icosphere(2)
    v = np.stack([v, 0.5 * v + 0.1])
    ct = np.random.RandomState(3).randn(2, 3, 3, len(faces)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda x: jgr.gather_face_vertices(x, jnp.asarray(faces), "xla", None, True),
        jnp.asarray(v),
    )
    (want_g,) = vjp(jnp.asarray(ct))
    x = torch.tensor(v, requires_grad=True)
    got = tgr.gather_face_vertices(x, torch.tensor(faces))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.tensor(ct))
    _close(x.grad.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("draw_backside", [True, False])
def test_resolve_and_gather_matches_jax_vjp(draw_backside):
    fvp, _ = _soup_planar(4, 2, 63)
    size = 64
    ct = np.random.RandomState(5).randn(2, 9, size, size).astype(np.float32)

    def jf(x):
        fim, fvm, _ = jgr.resolve_and_gather(
            x, None, 0, size, 0.1, 100.0, draw_backside, "pallas", None, False, True
        )
        return fvm, fim

    fvm, vjp, fim = jax.vjp(jf, jnp.asarray(fvp), has_aux=True)
    (want_g,) = vjp(jnp.asarray(ct))
    x = torch.tensor(fvp, requires_grad=True)
    got_fim, got_fvm, got_attrs = tgr.resolve_and_gather(x, size, 0.1, 100.0, draw_backside)
    assert got_attrs is None
    np.testing.assert_array_equal(got_fim.numpy(), np.asarray(fim))
    np.testing.assert_array_equal(got_fvm.detach().numpy(), np.asarray(fvm))
    assert not got_fim.requires_grad
    got_fvm.backward(torch.tensor(ct))
    assert (x.grad[:, 2] == 0).all()              # no gradient into z
    _close(x.grad.numpy(), np.asarray(want_g))
