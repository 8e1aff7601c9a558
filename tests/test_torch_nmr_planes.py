"""The NMR passes of the pipeline on the CPU (kernels K10-K12 run only on
the card, in ``test_torch_cuda.py``): ``rasterize._CoordinatePlanes``'s
plain forward and backward against the autograd chain they replaced
(``weight_planes_from_gathered``, ``coordinate_planes`` and autograd's
VJP of them), bit for bit, in the silhouette form and in the form that
writes weight planes; the coordinate gradient's wrapper against
``band_coordinate_grad_plain``; each wrapper's launch, with CUDA faked:
what it passes the kernel, the plain versions it counts and the dtypes it
refuses; and float64 backgrounds read in float32."""

import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu_torch.ops import differentiation as nmr
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops.rasterize import (
    RasterizeParam,
    _CoordinatePlanes,
    make_backgrounds,
)
from neural_renderer_v2_pytorch_tpu_torch.ops.resolve import (
    coordinate_planes,
    weight_planes_from_gathered,
)


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _winner_planes(seed, bs, rows, S, nan=False):
    """Winner planes [bs, 9, rows, S] and an index map [bs, rows, S] as the
    resolve leaves them (0 on background), with winners whose vertices 1
    and 2 coincide (a weight of exactly 0, negated where the winner is
    clockwise), and NaN planted in an XY plane if ``nan``."""
    rng = np.random.RandomState(seed)
    fvm = rng.uniform(-1.2, 1.2, (bs, 9, rows, S)).astype(np.float32)
    fim = rng.randint(0, 40, (bs, rows, S)).astype(np.int32)
    fim[:, : rows // 3] = -1                         # a background band
    fim[rng.rand(bs, rows, S) < 0.1] = -1
    same = rng.rand(bs, rows, S) < 0.15
    for coord in range(2):
        fvm[:, 6 + coord][same] = fvm[:, 3 + coord][same]
    fvm *= (fim >= 0)[:, None]
    if nan:
        fvm[0, 3, rows - 1, : S // 2] = np.nan
        fvm[-1, 1, rows // 3, 1] = np.nan            # on background too
    return torch.tensor(fvm), torch.tensor(fim)


def _cotangent(seed, bs, rows, S):
    g = np.random.RandomState(seed + 1).randn(bs, 2, rows, S).astype(np.float32)
    g[..., ::5] = 0.0
    return torch.tensor(g)


def _old_chain(fvm, fim, S, row_start, G):
    """The maps as ``rasterize._maps`` built them before the kernels, and
    autograd's gradient of the coordinate map onto the winner planes."""
    x = fvm.clone().requires_grad_(True)
    w = weight_planes_from_gathered(x, fim, S, row_start=row_start)
    coords = coordinate_planes(x, w)
    foreground = (fim >= 0).to(torch.float32)[:, None]
    coords.backward(G)
    return coords, w, foreground, x.grad


# (bs, rows, S, row_start): a whole 64^2 image, a band of a 100-wide
# image (not a power of two) from row 37, and one row
SHAPES = [(2, 64, 64, 0), (1, 23, 100, 37), (3, 1, 17, 5)]


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("bs,rows,S,row_start", SHAPES)
def test_coordinate_planes_function_gives_the_old_chains_bits(bs, rows, S, row_start, weights,
                                                              nan):
    fvm, fim = _winner_planes(bs * 100 + rows, bs, rows, S, nan)
    G = _cotangent(rows, bs, rows, S)
    want_coords, want_w, want_fg, want_grad = _old_chain(fvm, fim, S, row_start, G)

    x = fvm.clone().requires_grad_(True)
    coords, w, fg = _CoordinatePlanes.apply(x, fim, S, row_start, weights)
    assert (w is not None) == weights and not fg.requires_grad
    coords.backward(G)
    assert torch.equal(_bits(coords), _bits(want_coords))
    assert torch.equal(_bits(fg), _bits(want_fg))
    if weights:
        assert not w.requires_grad and torch.equal(_bits(w), _bits(want_w))
    assert torch.equal(_bits(x.grad), _bits(want_grad))
    assert x.grad[:, 2::3].abs().max() == 0
    # the inputs reach the cases the kernels must repeat: -0 products
    # (which the old chain's sums turned into +0) and, with ``nan``, NaN
    products = G[:, :, None] * want_w[:, None]
    assert bool(((products == 0) & products.signbit()).any())
    assert bool(want_grad.isnan().any()) == nan


def test_nmr_coordinate_grad_on_the_cpu_is_the_plain_version():
    rng = np.random.RandomState(5)
    images = torch.tensor((rng.rand(2, 3, 10, 12) > 0.5).astype(np.float32))
    grad = torch.tensor(rng.randn(2, 3, 10, 12).astype(np.float32))
    edge = torch.tensor(rng.randn(2, 6, 2, 12).astype(np.float32))
    above, below = (edge[:, :3, :1], edge[:, 3:, :1]), (edge[:, :3, 1:], edge[:, 3:, 1:])
    for halo in ((None, None), (above, None), (above, below), (None, below)):
        got = rc.nmr_coordinate_grad(images, grad, *halo, 40)
        want = nmr.band_coordinate_grad_plain(images, grad, *halo, 40)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(nmr.band_coordinate_grad(images, grad, *halo, 40)), _bits(want))
    assert rc.LAUNCHES[rc.NMR_PLAIN] == 0


@pytest.fixture
def launches(monkeypatch):
    """Each wrapper's launches with CUDA faked on CPU tensors: [(entry,
    args)]."""
    seen = []
    monkeypatch.setattr(rc, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(rc, "_launch", lambda entry, index, *args: seen.append((entry, args)))
    rc.reset_launches()
    return seen


def test_planes_launch_reads_a_slice_of_planes_in_place(launches):
    """K10 and K11 read the winner planes where they lie, a slice of a
    larger map too (the face-sharded path's winner planes and attributes),
    by its batch stride; K10 writes no weight planes unless asked."""
    bs, rows, S, A = 2, 6, 16, 5
    planes = torch.zeros(bs, 9 + A, rows, S)
    fvm, fim = planes[:, :9], torch.zeros(bs, rows, S, dtype=torch.int32)
    xp, yp = rc._pixel_grid(S, "cpu", 3, rows)
    for weights in (False, True):
        coords, w, fg = rc.nmr_planes(fvm, fim, S, 3, weights)
        assert coords.shape == (bs, 2, rows, S) and fg.shape == (bs, 1, rows, S)
        entry, args = launches[-1]
        assert entry == "nmr_planes"
        assert args[:4] == (fvm.data_ptr(), fim.data_ptr(), xp.data_ptr(), yp.data_ptr())
        assert args[5] == (w.data_ptr() if weights else 0) and (w is None) != weights
        assert args[7:] == (bs, rows, S, (9 + A) * rows * S)
    grad = torch.zeros(bs, 2, rows, S)
    assert rc.nmr_planes_vjp(grad, fvm, fim, S, 3).shape == (bs, 9, rows, S)
    entry, args = launches[-1]
    assert entry == "nmr_planes_vjp" and args[:3] == (grad.data_ptr(), fvm.data_ptr(),
                                                      fim.data_ptr())
    assert args[6:] == (bs, rows, S, (9 + A) * rows * S)
    assert rc.nmr_planes(fvm[:1], fim[:1], S)[0].shape == (1, 2, rows, S)
    assert launches[-1][1][-1] == 9 * rows * S          # one image: its own planes
    assert rc.LAUNCHES[rc.NMR_PLAIN] == 0


def test_coordinate_grad_launch_takes_the_halo_rows_in_place(launches):
    """K12 takes a band's halo rows as the all-gather leaves them (images
    and gradient as two channel ranges of one tensor) by their strides,
    null pointers at an image edge, and the step 2 / render size."""
    bs, C, rows, W = 2, 4, 5, 12
    images, grad = torch.zeros(bs, C, rows, W), torch.zeros(bs, C, rows, W)
    edge = torch.zeros(bs, 2 * C, 2, W)
    above = edge[:, :C, 1:], edge[:, C:, 1:]
    out = rc.nmr_coordinate_grad(images, grad, above, None, 30)
    assert out.shape == (bs, 2, rows, W)
    entry, args = launches[-1]
    assert entry == "nmr_coordinate_grad"
    assert args[:6] == (images.data_ptr(), grad.data_ptr(), above[0].data_ptr(),
                        above[1].data_ptr(), 0, 0)
    assert args[7:11] == (bs, C, rows, W)
    assert args[11:] == (4 * C * W, 2 * W, 0, 0, 2.0 / 30)
    rc.nmr_coordinate_grad(images, grad, None, (images[:, :, :1], grad[:, :, :1]), 30)
    assert launches[-1][1][2:6] == (0, 0, images.data_ptr(), grad.data_ptr())
    assert launches[-1][1][11:15] == (0, 0, C * rows * W, rows * W)
    assert len(launches) == 2 and rc.LAUNCHES[rc.NMR_PLAIN] == 0


def test_plain_versions_on_cuda_tensors_are_counted(launches):
    """Inside ``plain_versions()`` each NMR pass takes its plain version and
    counts it in ``nmr_plain``; outside it, tensors of another dtype raise
    (no fallback)."""
    fvm, fim = _winner_planes(0, 1, 8, 8)
    G = _cotangent(0, 1, 8, 8)
    images = torch.rand(1, 1, 8, 8)
    with rc.plain_versions():
        rc.nmr_planes(fvm, fim, 8)
        rc.nmr_planes_vjp(G, fvm, fim, 8)
        rc.nmr_coordinate_grad(images, images, None, None, 8)
    assert rc.LAUNCHES[rc.NMR_PLAIN] == 3
    with pytest.raises(ValueError, match="nmr_planes: want torch.float32"):
        rc.nmr_planes(fvm.double(), fim, 8)
    with pytest.raises(ValueError, match="nmr_planes_vjp: want torch.int32"):
        rc.nmr_planes_vjp(G, fvm, fim.long(), 8)
    with pytest.raises(ValueError, match="nmr_coordinate_grad: want torch.float32"):
        rc.nmr_coordinate_grad(images.double(), images.double(), None, None, 8)
    assert rc.LAUNCHES[rc.NMR_PLAIN] == 3 and launches == []
    rc.reset_launches()
    assert rc.LAUNCHES[rc.NMR_PLAIN] == 0


def test_float64_backgrounds_are_read_in_float32():
    """A float64 background image is read in float32, as the JAX package
    reads it (x64 off), so the images the NMR passes see are float32."""
    backgrounds = torch.tensor(np.random.RandomState(6).rand(2, 3, 8, 8))
    got = make_backgrounds(RasterizeParam(backgrounds=backgrounds), 2, 8, "cpu")
    assert got.dtype == torch.float32 and torch.equal(got, backgrounds.float())
