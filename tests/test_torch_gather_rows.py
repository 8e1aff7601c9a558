"""Kernel K9's plain version, ``to_map`` and ``gather_winner_planes`` of the
PyTorch port against the JAX package.

The row gather is a copy, so values are bit-equal to the JAX package's
``gather_rows_pallas`` (run in interpret mode) and ``to_map``.  Gradients
(the transpose, a scatter-add) are held to rtol 1e-6 against JAX's
``to_map`` VJP: both sum each row's pixels, in another grouping."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu_torch as tnr
from neural_renderer_v2_pytorch_tpu.ops.maps import to_map as jax_to_map
from neural_renderer_v2_pytorch_tpu.ops.resolve_pallas import gather_rows_pallas
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops.gather_resolve import gather_winner_planes


def _table_ids(seed, bs, n, D, P, low=0):
    rng = np.random.RandomState(seed)
    table = rng.randn(bs, n, D).astype(np.float32)
    ids = rng.randint(low, n, (bs, P)).astype(np.int32)
    return table, ids


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("D,n,P", [(3, 97, 301), (9, 517, 1000), (27, 130, 777)])
def test_gather_rows_plain_is_bit_equal_to_pallas(D, n, P, planar):
    table, ids = _table_ids(D, 2, n, D, P)
    want = np.asarray(gather_rows_pallas(jnp.asarray(table), jnp.asarray(ids), interpret=True,
                                         planar_out=planar))
    got = rc.gather_rows(torch.tensor(table), torch.tensor(ids), planar=planar)
    assert got.shape == ((2, D, P) if planar else (2, P, D))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_rows_masks_negative_ids_and_shares_ids_across_the_batch():
    table, ids = _table_ids(1, 3, 40, 5, 64, low=-1)
    got = rc.gather_rows(torch.tensor(table), torch.tensor(ids), planar=True)
    want = np.where((ids >= 0)[..., None], table[np.arange(3)[:, None], np.maximum(ids, 0)], 0)
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 2, 1))
    shared = torch.tensor(ids[:1]).expand(3, -1)          # batch stride 0
    got = rc.gather_rows(torch.tensor(table), shared)
    want = np.where((ids[:1] >= 0)[..., None], table[:, np.maximum(ids[0], 0)], 0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("trailing", [(), (2,), (3, 3)])
def test_to_map_is_bit_equal_to_jax(trailing):
    rng = np.random.RandomState(len(trailing))
    data = rng.randn(2, 57, *trailing).astype(np.float32)
    index = rng.randint(-1, 57, (2, 9, 11)).astype(np.int32)
    want = np.asarray(jax_to_map(jnp.asarray(data), jnp.asarray(index)))
    got = tnr.to_map(torch.tensor(data), torch.tensor(index))
    assert got.shape == (2, 9, 11, *trailing)
    np.testing.assert_array_equal(got.numpy(), want)


def test_to_map_gradient_matches_jax_vjp():
    rng = np.random.RandomState(7)
    data = rng.randn(2, 31, 3, 2).astype(np.float32)
    index = rng.randint(-1, 31, (2, 16, 16)).astype(np.int32)
    ct = rng.randn(2, 16, 16, 3, 2).astype(np.float32)
    _, vjp = jax.vjp(lambda d: jax_to_map(d, jnp.asarray(index)), jnp.asarray(data))
    (want,) = vjp(jnp.asarray(ct))
    x = torch.tensor(data, requires_grad=True)
    tnr.to_map(x, torch.tensor(index)).backward(torch.tensor(ct))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("D", [9, 27])
def test_gather_winner_planes_matches_jax_to_map_and_vjp(D):
    """The face-sharded path's winner planes: the JAX package's
    ``to_map(per_face, index).transpose(0, 3, 1, 2)`` and its VJP."""
    rng = np.random.RandomState(D)
    per_face = rng.randn(2, 45, D).astype(np.float32)
    index = rng.randint(-1, 45, (2, 12, 20)).astype(np.int32)
    ct = rng.randn(2, D, 12, 20).astype(np.float32)
    out, vjp = jax.vjp(lambda p: jax_to_map(p, jnp.asarray(index)).transpose(0, 3, 1, 2),
                       jnp.asarray(per_face))
    (want_g,) = vjp(jnp.asarray(ct))
    x = torch.tensor(per_face, requires_grad=True)
    got = gather_winner_planes(x, torch.tensor(index))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.tensor(ct))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=0)


def test_cpu_gathers_launch_nothing():
    rc.reset_launches()
    table, ids = _table_ids(3, 1, 20, 4, 30, low=-1)
    x = torch.tensor(table, requires_grad=True)
    tnr.to_map(x, torch.tensor(ids).reshape(1, 5, 6)).sum().backward()
    gather_winner_planes(x, torch.tensor(ids).reshape(1, 5, 6)).sum().backward()
    assert all(n == 0 for n in rc.LAUNCHES.values()), rc.LAUNCHES
