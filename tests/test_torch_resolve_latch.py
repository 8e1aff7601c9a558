"""The plain versions of the port's kernels K2L (resolve with coordinate
and attribute latch) and K5 (planar face gather), and the row scatter that
K6's plain version starts from, against the JAX package's Pallas kernels
in interpret mode; the latching resolve's autograd Function against the
JAX VJP; and the kernel-routing switch.

K2L and K5 are copies and must be bit-equal.  The row scatter is held to
1e-5 of the largest magnitude: the Pallas kernel splits gradients into
bf16 halves (~2^-17 relative)."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu.ops import gather_resolve as jgr
from neural_renderer_v2_pytorch_tpu.ops.resolve_pallas import (
    gather_faces3_pallas,
    resolve_gather_pallas,
    scatter_rows_pallas,
)
from neural_renderer_v2_pytorch_tpu_torch.ops import gather_resolve as tgr
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import icosphere


def _soup(seed, bs, nf):
    rng = np.random.RandomState(seed)
    fv = rng.uniform(-1, 1, (bs, nf, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    fv[:, 1] = fv[:, 0]                       # exact duplicate
    fv[:, 2, 1] = fv[:, 2, 0]                 # degenerate
    return fv


def _planar(fv):
    return np.ascontiguousarray(fv.transpose(0, 3, 2, 1))


@pytest.mark.parametrize("draw_backside", [True, False])
@pytest.mark.parametrize("num_attrs", [6, 27])
def test_resolve_latch_plain_is_bit_equal_to_pallas(num_attrs, draw_backside):
    fv = _soup(7, 2, 43)
    fvp = _planar(fv)
    attrs = np.random.RandomState(8).randn(2, 43, num_attrs).astype(np.float32)
    size = 48
    index, coords, attr_planes = resolve_gather_pallas(
        jnp.asarray(fvp), jnp.asarray(attrs), size, draw_backside=draw_backside,
        interpret=True, latch_z=True, planar_faces=True,
    )
    t = torch.tensor(fvp)
    got_index, _, got_coords, got_attrs = rc.resolve_latch(
        t, torch.tensor(attrs), draw_backside, size, 0.1, 100.0
    )
    np.testing.assert_array_equal(got_index.numpy(), np.asarray(index))
    np.testing.assert_array_equal(got_coords.numpy(), np.asarray(coords))
    np.testing.assert_array_equal(got_attrs.numpy(), np.asarray(attr_planes))
    assert (got_index.numpy() >= 0).mean() > 0.2


@pytest.mark.parametrize("D", [3, 5])
def test_gather_faces3_plain_is_bit_equal_to_pallas(D):
    _, faces = icosphere(2)
    nv, nf = int(faces.max()) + 1, len(faces)
    table = np.random.RandomState(D).randn(2, nv, D).astype(np.float32)
    ids3 = jnp.broadcast_to(jnp.asarray(faces.T)[None], (2, 3, nf))
    want = np.asarray(gather_faces3_pallas(jnp.asarray(table), ids3, interpret=True))
    got = rc.gather_faces3(torch.tensor(table), torch.tensor(faces))
    assert got.shape == (2, D, 3, nf)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_rows_plain_matches_pallas():
    """12 quad channels, ids with repeats and -1 (skipped), a table larger
    than one of the kernel's accumulator parts."""
    rng = np.random.RandomState(9)
    bs, D, P, T = 2, 12, 3000, 5000
    g = rng.randn(bs, D, P).astype(np.float32)
    ids = rng.randint(-1, 700, size=(bs, P)).astype(np.int32)
    want = np.asarray(scatter_rows_pallas(
        jnp.asarray(g), jnp.asarray(ids), T, strip=512, chunk=128,
        part_bytes=128 * 128 * 4 * D, interpret=True,
    ))
    got = rc.scatter_rows_plain(torch.tensor(g), torch.tensor(ids), T).numpy()
    assert got.shape == (bs, T, D)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_resolve_and_gather_latch_matches_jax_vjp():
    """Values bit-equal, and the gradients of the nine coordinate planes
    (z included) and the attribute planes, through one D = 9 + A scatter,
    against the JAX VJP (its exact XLA segment-sum path)."""
    fv = _soup(10, 2, 61)
    attrs = np.random.RandomState(11).randn(2, 61, 15).astype(np.float32)
    size = 48
    rng = np.random.RandomState(12)
    ct_fvm = rng.randn(2, 9, size, size).astype(np.float32)
    ct_attr = rng.randn(2, 15, size, size).astype(np.float32)

    def jf(x, a):
        fim, fvm, ap = jgr.resolve_and_gather(
            x, a, 0, size, 0.1, 100.0, True, "xla", None, True, False
        )
        return (fvm, ap), fim

    (fvm, ap), vjp, fim = jax.vjp(jf, jnp.asarray(fv), jnp.asarray(attrs), has_aux=True)
    want_gx, want_ga = vjp((jnp.asarray(ct_fvm), jnp.asarray(ct_attr)))

    x = torch.tensor(_planar(fv), requires_grad=True)
    a = torch.tensor(attrs, requires_grad=True)
    got_fim, got_fvm, got_ap = tgr.resolve_and_gather(x, size, 0.1, 100.0, True, a, True)
    np.testing.assert_array_equal(got_fim.numpy(), np.asarray(fim))
    np.testing.assert_array_equal(got_fvm.detach().numpy(), np.asarray(fvm))
    np.testing.assert_array_equal(got_ap.detach().numpy(), np.asarray(ap))
    torch.autograd.backward((got_fvm, got_ap), (torch.tensor(ct_fvm), torch.tensor(ct_attr)))
    want_gx = _planar(np.asarray(want_gx))
    assert np.abs(want_gx[:, 2]).max() > 0               # z takes gradients
    for got, want in ((x.grad.numpy(), want_gx), (a.grad.numpy(), np.asarray(want_ga))):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_resolve_and_gather_latch_without_attrs():
    fvp = _planar(_soup(13, 1, 20))
    x = torch.tensor(fvp, requires_grad=True)
    fim, fvm, attrs = tgr.resolve_and_gather(x, 32, 0.1, 100.0, True, None, True)
    assert attrs is None and fvm.shape == (1, 9, 32, 32)
    fvm[:, 2::3].sum().backward()                        # the z planes only
    assert (x.grad[:, :2] == 0).all() and (x.grad[:, 2] != 0).any()
    with pytest.raises(ValueError, match="latch_z"):
        tgr.resolve_and_gather(x, 32, 0.1, 100.0, True, torch.zeros(1, 20, 3), False)


def _kernel_args():
    """Small CPU inputs for every wrapper in rc.KERNELS: (args, kwargs)."""
    fvp = torch.tensor(_planar(_soup(14, 1, 9)))
    _, faces = icosphere(0)
    faces = torch.tensor(faces)
    fim = torch.randint(-1, 9, (1, 8, 8), dtype=torch.int32)
    bins = rc.bin_faces_plain(fvp, True, 40)
    fvm = torch.rand((1, 9, 8, 8), generator=torch.Generator().manual_seed(0))
    # the loaded-atlas sampler: depths, texel coordinates in a 5 x 7 atlas,
    # the atlas, the index map, weights, eps
    sampler = (fvm[:, 2::3] + 1, fvm[:, :6] * 4, torch.ones(1, 3, 5, 7), fim, fvm[:, 6:], 1e-5)
    return {
        "face_setup": ((fvp, True), {}),
        "resolve_xy": ((fvp, True, 16, 0.1, 100.0), {}),
        "resolve_latch": ((fvp, torch.ones(1, 9, 4), True, 16, 0.1, 100.0), {}),
        "resolve_depth": ((fvp, False, 16, 0.1, 100.0, 4, 9), {}),
        "scatter_pixels_to_faces": ((torch.ones(1, 6, 8, 8), fim, 9), {}),
        "scatter_faces_to_vertices": ((torch.ones(1, 3, 3, 20), faces, 12), {}),
        "gather_faces3": ((torch.ones(1, 12, 3), faces), {}),
        "atlas_taps_grad": ((torch.ones(1, 12, 64), fim.reshape(1, 64), 3, 9), {}),
        "bin_faces": ((fvp, True, 40), {}),
        "resolve_binned_xy": ((fvp, True, bins, 40, 0.1, 100.0), {}),
        "resolve_binned_latch": ((fvp, torch.ones(1, 9, 4), False, bins, 40, 0.1, 100.0), {}),
        "resolve_binned_depth": ((fvp, True, bins, 40, 0.1, 100.0), {}),
        "gather_rows": ((torch.ones(1, 9, 5), fim.reshape(1, 64)), {"planar": True}),
        "nmr_planes": ((fvm, fim, 8), {"weights": True}),
        "nmr_planes_vjp": ((torch.ones(1, 2, 8, 8), fvm, fim, 8), {}),
        "nmr_coordinate_grad": ((torch.ones(1, 2, 8, 8), fvm[:, :2], None, None, 16), {}),
        "atlas_sample": (sampler, {}),
        "atlas_sample_vjp": ((torch.ones(1, 3, 8, 8), *sampler), {}),
    }


def test_plain_versions_switch_covers_every_wrapper(monkeypatch):
    """With CUDA pretended, each wrapper reaches its kernel launch, and
    inside ``plain_versions()`` none does: each gives its plain result."""
    args = _kernel_args()
    assert sorted(args) == sorted(rc.KERNELS)
    launched = []
    monkeypatch.setattr(rc, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(rc, "_latch_limits",
                        lambda device, binned=False: (256, 1024, 18000, 49152))

    def launch(name, device, *a):
        if name == "bin_faces_count":
            # K7's count pass: what its memset leaves in the scratch of one
            # scan tile (no pairs), which the wrapper reads back
            ctypes.memset(a[1], 0, 4 * (rc.BIN_SCAN_TILE + 4))
        else:
            launched.append(name)

    monkeypatch.setattr(rc, "_launch", launch)
    for name, (a, kw) in args.items():
        getattr(rc, name)(*a, **kw)
    assert launched == list(args)
    launched.clear()
    with rc.plain_versions():
        for name, (a, kw) in args.items():
            got, want = getattr(rc, name)(*a, **kw), getattr(rc, name + "_plain")(*a, **kw)
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(g, w), name
    assert launched == []
    assert rc._route == {"plain": False, "mode": None}


def test_wrappers_take_plain_versions_on_cpu_without_launching():
    rc.reset_launches()
    for name, (a, kw) in _kernel_args().items():
        getattr(rc, name)(*a, **kw)
    assert all(n == 0 for n in rc.LAUNCHES.values()), rc.LAUNCHES


def test_latch_limit_check_names_the_attribute_count():
    assert rc.latch_limit_error(36, 256, 1024, 18000, 49152) is None
    msg = rc.latch_limit_error(36, 256, 128, 18000, 49152)
    assert "A=36" in msg and "256 threads" in msg
    assert "A=6" in rc.latch_limit_error(6, 256, 1024, 60000, 49152)
    assert rc.latch_limit_error(27, 256, 128, 18000, 49152,
                                kernel="resolve_binned_latch").startswith(
        "resolve_binned_latch with A=27")
