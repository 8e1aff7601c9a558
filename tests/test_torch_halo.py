"""The sharded entry's global stage on row bands (``parallel/render.py``),
without ranks: each band's NMR backward, given its neighbours' edge rows
as the halo exchange gathers them, against the whole image's
(``ops.differentiation._coordinate_grad``) bit for bit; and the bands'
blend, flip and pool, placed as the image gather places them, against
``finalize_images`` on the whole canvas, forward and backward."""

import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu_torch import parallel
from neural_renderer_v2_pytorch_tpu_torch.ops import differentiation as nmr
from neural_renderer_v2_pytorch_tpu_torch.ops.rasterize import (
    RasterizeHyperparam,
    finalize_images,
)
from neural_renderer_v2_pytorch_tpu_torch.parallel import render


def _bands(image_size, anti_aliasing, n_tile):
    """(render size, band rows, [(first row, real rows)] of each band)."""
    size = image_size * (2 if anti_aliasing else 1)
    rows = parallel.band_rows(image_size, anti_aliasing, n_tile)
    return size, rows, [(t * rows, render._real_rows(size, rows, t)) for t in range(n_tile)]


def _bits(t):
    return t.detach().numpy().view(np.int32)


# (channels, image size, anti-aliasing, tiles): an even split, uneven ones
# (33 rows as 17 + 16; 66 as 18 x 3 + 12; 20 as 7 + 7 + 6) and one with
# empty bands (24 rows as 4 x 6 + 0 + 0)
SPLITS = [(1, 16, True, 2), (1, 33, False, 2), (4, 33, True, 4), (3, 20, False, 3),
          (4, 12, True, 8), (1, 12, True, 8)]


@pytest.mark.parametrize("C,image_size,anti_aliasing,n_tile", SPLITS)
def test_band_nmr_backward_is_the_whole_images_rows(C, image_size, anti_aliasing, n_tile):
    size, rows, bands = _bands(image_size, anti_aliasing, n_tile)
    rng = np.random.RandomState(C * 100 + image_size)
    images = rng.rand(2, C, size, size).astype(np.float32)
    if C == 1:
        images = (images > 0.5).astype(np.float32)       # a silhouette's steps
    images = torch.tensor(images)
    grad = torch.tensor(rng.randn(2, C, size, size).astype(np.float32))
    whole = nmr._coordinate_grad(images, grad)
    assert whole.abs().max() > 0

    cut = [(images[:, :, r0:r0 + n], grad[:, :, r0:r0 + n]) for r0, n in bands]
    halo = torch.stack([render._band_edges(i, g) for i, g in cut])     # what the ranks gather
    got = [render._band_grad(i, g, halo, t, rows, size) for t, (i, g) in enumerate(cut)]
    for (r0, n), g in zip(bands, got):
        assert g.shape == (2, 2, n, size)
        np.testing.assert_array_equal(_bits(g), _bits(whole[:, :, r0:r0 + n]))
    np.testing.assert_array_equal(_bits(torch.cat(got, 2)), _bits(whole))
    if image_size == 12 and n_tile == 8:
        assert [n for _, n in bands] == [4, 4, 4, 4, 4, 4, 0, 0]


def test_band_edges_of_an_empty_band_are_zeros():
    images = torch.ones(2, 3, 0, 8)
    edges = render._band_edges(images, images)
    assert edges.shape == (2, 6, 2, 8) and not edges.any()


@pytest.mark.parametrize("anti_aliasing", [True, False])
@pytest.mark.parametrize("backgrounds", [True, False])
@pytest.mark.parametrize("n_data,n_tile,image_size", [(1, 2, 16), (2, 4, 11), (1, 8, 12)])
def test_band_stage_assembles_to_finalize_images(anti_aliasing, backgrounds, n_data, n_tile,
                                                 image_size):
    """Each band's crop, background rows, blend, hook, flip and pool, placed
    at its mirrored rows: the whole canvas's ``finalize_images``, and the
    band's slice of the cotangent gives the whole canvas's image and
    background gradients."""
    size, rows, bands = _bands(image_size, anti_aliasing, n_tile)
    hp = RasterizeHyperparam(image_size=image_size, anti_aliasing=anti_aliasing)
    rng = np.random.RandomState(image_size + n_tile)
    bs, bl = 2 * n_data, 2
    padded = rows * n_tile            # the ranks render whole bands, then crop
    images = torch.tensor(rng.rand(bs, 4, padded, size).astype(np.float32))
    coords = torch.tensor(rng.randn(bs, 2, padded, size).astype(np.float32))
    foreground = torch.tensor((rng.rand(bs, 1, padded, size) > 0.4).astype(np.float32))
    bg = torch.tensor(rng.rand(bs, 3, size, size).astype(np.float32)) if backgrounds else None
    out_size = image_size
    cot = torch.tensor(rng.randn(bs, 4, out_size, out_size).astype(np.float32))

    def leaf(t):
        return None if t is None else t.clone().requires_grad_(True)

    whole_in, whole_bg = leaf(images), leaf(bg)
    want = finalize_images(whole_in[:, :, :size], coords[:, :, :size], foreground[:, :, :size],
                           whole_bg, hp)
    want.backward(cot)

    band_in, band_bg = leaf(images), leaf(bg)
    pool = 2 if anti_aliasing else 1
    counts = [n // pool for _, n in bands]
    finished = torch.zeros(n_data, n_tile, bl, 4, max(counts), out_size)
    for d in range(n_data):
        mine = slice(d * bl, (d + 1) * bl)
        for t, (r0, n) in enumerate(bands):
            crop = [m[mine, :, r0:r0 + rows][:, :, :n] for m in (band_in, coords, foreground)]
            b = None if bg is None else render._band_backgrounds(band_bg[mine], size, r0, n)
            # the hook's forward is the identity; its coordinate gradient is
            # the test above's
            out = finalize_images(*crop, b, hp, hook=lambda i, c: i)
            assert out.shape == (bl, 4, counts[t], out_size)
            finished[d, t, :, :, :counts[t]] = out.detach()
            top = render._band_top(counts, t)
            out.backward(cot[mine, :, top:top + counts[t]])    # _GatherImages' backward
    got = render._assemble(finished, counts)
    np.testing.assert_array_equal(got.numpy(), want.detach().numpy())
    np.testing.assert_array_equal(band_in.grad.numpy(), whole_in.grad.numpy())
    if bg is not None:
        assert band_bg.grad.abs().max() > 0
        np.testing.assert_array_equal(band_bg.grad.numpy(), whole_bg.grad.numpy())
