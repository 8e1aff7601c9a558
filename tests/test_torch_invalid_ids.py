"""Ids outside the table in the port's gathers and the vertex scatter, on
the CPU tier, against the JAX package's Pallas kernels in interpret mode.

The TPU kernels are one-hot products: an id outside [0, n) matches no row,
so a gather reads 0 there and the scatter adds nothing.  The port's
kernels do the same on the card (``tests/test_torch_cuda.py``); here their
plain versions are held to the JAX kernels on ids of -1, -7, n and n + 5,
with tables of a multiple of the kernels' chunk rows and of other sizes
(an id of n then falls into the kernels' zero padding, or past it).  Each
JAX function takes all of these ids.  The gathers are copies and must be
bit-equal; the scatter is held to 1e-4 of the largest magnitude, because
``_scatter3_kernel`` splits the gradient into bf16 hi + lo parts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu.ops.resolve_pallas import (
    gather_faces3_pallas,
    gather_rows_pallas,
    scatter_slots3_pallas,
)
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc

OUTSIDE = (-1, -7)          # with n and n + 5 below


def _ids(rng, n, shape):
    ids = rng.randint(0, n, shape).astype(np.int32)
    flat = ids.reshape(-1)
    flat[:6] = [*OUTSIDE, n, n + 5, n - 1, 0]
    return ids


def _faces(rng, n, nf):
    faces = rng.randint(0, n, (nf, 3)).astype(np.int32)
    faces[:4, 0] = [*OUTSIDE, n, n + 5]
    faces[5, 1], faces[6, 2] = n + 5, -1
    return faces


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("n", [40, 512, 600])
def test_row_gather_reads_zero_outside_the_table_as_pallas(n, planar):
    rng = np.random.RandomState(n)
    table = rng.randn(2, n, 5).astype(np.float32)
    ids = _ids(rng, n, (2, 300))
    want = np.asarray(gather_rows_pallas(jnp.asarray(table), jnp.asarray(ids), interpret=True,
                                         planar_out=planar))
    got = rc.gather_rows(torch.tensor(table), torch.tensor(ids), planar=planar).numpy()
    np.testing.assert_array_equal(got, want)
    outside = (ids < 0) | (ids >= n)
    assert outside.sum() == 4 * 1 and (want[0, :, :4] if planar else want[0, :4]).max() == 0


@pytest.mark.parametrize("n", [40, 512, 600])
def test_face_vertex_gather_reads_zero_outside_the_table_as_pallas(n):
    rng = np.random.RandomState(n + 1)
    table = rng.randn(2, n, 3).astype(np.float32)
    faces = _faces(rng, n, 200)
    ids3 = jnp.broadcast_to(jnp.asarray(faces.T)[None], (2, 3, 200))
    want = np.asarray(gather_faces3_pallas(jnp.asarray(table), ids3, interpret=True))
    got = rc.gather_faces3(torch.tensor(table), torch.tensor(faces)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, :, 0, :4] == 0).all() and (got[:, :, 0, 4:] != 0).any()


@pytest.mark.parametrize("n", [40, 512, 600])
def test_vertex_scatter_adds_nothing_outside_the_table_as_pallas(n):
    rng = np.random.RandomState(n + 2)
    faces = _faces(rng, n, 200)
    g = rng.randn(2, 3, 3, 200).astype(np.float32)
    ids3 = jnp.broadcast_to(jnp.asarray(faces.T)[None], (2, 3, 200))
    want = np.asarray(scatter_slots3_pallas(jnp.asarray(g), ids3, n, interpret=True))
    got = rc.scatter_faces_to_vertices(torch.tensor(g), torch.tensor(faces), n).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # the same bits as the sum over the slots inside the table alone, in
    # slot order: the outside slots are dropped, not clamped or wrapped
    inside = g.copy()
    inside.transpose(0, 3, 2, 1)[:, (faces < 0) | (faces >= n)] = 0.0
    clean = np.where((faces >= 0) & (faces < n), faces, 0)
    want_bits = rc.scatter_faces_to_vertices_plain(torch.tensor(inside), torch.tensor(clean), n)
    np.testing.assert_array_equal(got, want_bits.numpy())
