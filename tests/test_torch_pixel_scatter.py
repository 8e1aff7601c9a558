"""Kernel K3 (``csrc/scatter_pixels_to_faces.cu``) emulated step by step in
numpy, against the port's plain version and the JAX package's Pallas
scatter in interpret mode.

The emulation follows the kernel's block: 256 lanes over a run of 256
consecutive pixels of an image (or, to hold other block shapes to the
same sums, over a tile of ``tile_w`` x 256 / ``tile_w`` pixels), a block
with no covered pixel skipped; per warp the runs of equal ids (a segmented
shuffle reduction into each run's head, simultaneous reads as
``__shfl_down_sync`` gives them), the heads of one face grouped as
``__match_any_sync`` groups them and summed in lane order by the warp's
leader; across warps each face's warp sums added in warp order by the
leader of the lowest warp, which issues one add per (face, plane).  The
blocks' adds land in a seeded random order, standing in for the atomics.
Everything is float32, so the emulation's sums are the kernel's in-block
sums.  Tolerance 1e-4 of the largest magnitude: the plain version and the
Pallas kernel (bf16 halves, ~2^-17) sum in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu.ops.resolve import compute_face_index_map
from neural_renderer_v2_pytorch_tpu.ops.resolve_pallas import scatter_to_faces_pallas
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc

THREADS = 256


def _warp_sums(f, x):
    """One warp: lane ids ``f`` [32] (-1 uncovered) and values ``x``
    [D, 32] -> {face: its sum over the warp's lanes} as the kernel forms
    it: each run into its head by the segmented shuffle reduction, then the
    heads of the face in lane order."""
    lanes = np.arange(32)
    head = np.ones(32, bool)
    head[1:] = f[1:] != f[:-1]
    heads = np.flatnonzero(head)
    # end of each lane's run: the lane before the next head, else 31
    nxt = np.searchsorted(heads, lanes, side="right")
    end = np.where(nxt < len(heads), heads[np.minimum(nxt, len(heads) - 1)] - 1, 31)
    x = x.copy()
    off = 1
    while off < 32:
        src = np.where(lanes + off < 32, lanes + off, lanes)      # __shfl_down_sync
        o = x[:, src]
        x = np.where(lanes + off <= end, x + o, x).astype(np.float32)
        off *= 2
    sums = {}
    for lane in heads:                                             # ascending lanes
        if f[lane] < 0:
            continue
        face = int(f[lane])
        sums[face] = x[:, lane].copy() if face not in sums else (sums[face] + x[:, lane])
    return sums


def _blocks(H, W, tile_w):
    """Each block's pixels, flat indices [256] (-1 past the canvas): runs
    of 256 (the kernel's block) when ``tile_w`` is None, else tiles of
    ``tile_w`` x 256 / ``tile_w`` pixels."""
    tid = np.arange(THREADS)
    if tile_w is None:
        for start in range(0, H * W, THREADS):
            yield np.where(start + tid < H * W, start + tid, -1)
        return
    tile_h = THREADS // tile_w
    for r0 in range(0, H, tile_h):
        for c0 in range(0, W, tile_w):
            row, col = r0 + tid // tile_w, c0 + tid % tile_w
            yield np.where((row < H) & (col < W), row * W + col, -1)


def emulate_k3(g, fim, nf, tile_w=None, seed=0):
    """K3 over g f32 [bs, D, H, W] and fim i32 [bs, H, W], with blocks as
    :func:`_blocks` lays them: (out f32 [bs, D, nf], the number of adds
    issued)."""
    bs, D, H, W = g.shape
    g, fim = g.reshape(bs, D, H * W), fim.reshape(bs, H * W)
    out = np.zeros((bs, D, nf), np.float32)
    blocks = []
    for b in range(bs):
        for pix in _blocks(H, W, tile_w):
            inside = pix >= 0
            f = np.full(THREADS, -1)
            f[inside] = fim[b, pix[inside]]
            f = np.where((f >= 0) & (f < nf), f, -1)
            if not (f >= 0).any():
                continue                           # background: the id read only
            x = np.zeros((D, THREADS), np.float32)
            cov = f >= 0
            x[:, cov] = g[b][:, pix[cov]]
            per_face = {}
            for w in range(THREADS // 32):         # warp order
                lanes = slice(32 * w, 32 * w + 32)
                for face, s in _warp_sums(f[lanes], x[:, lanes]).items():
                    per_face[face] = s if face not in per_face else (per_face[face] + s)
            blocks.append((b, per_face))
    adds = 0
    for k in np.random.RandomState(seed).permutation(len(blocks)):
        b, per_face = blocks[k]
        for face, s in per_face.items():
            out[b, :, face] += s
            adds += D
    return out, adds


def _soup_map(seed, bs, nf, size):
    rng = np.random.RandomState(seed)
    fv = rng.uniform(-1, 1, (bs, nf, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    return np.asarray(compute_face_index_map(jnp.asarray(fv), size)).astype(np.int32)


def _map(name, bs, size):
    """(index map i32 [bs, size, size], nf): the resolve's map of a
    triangle soup of 57 faces, one face of 57 winning every pixel, or a
    checkerboard of distinct winners (one face a pixel) on background."""
    if name == "soup":
        return _soup_map(0, bs, 57, size), 57
    if name == "one face":
        return np.full((bs, size, size), 19, np.int32), 57
    i, j = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    checker = np.where((i + j) % 2 == 0, i * size + j, -1)
    return np.ascontiguousarray(np.broadcast_to(checker, (bs, size, size)),
                                dtype=np.int32), size * size


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("D", [6, 15, 36])
@pytest.mark.parametrize("name", ["soup", "one face", "checkerboard"])
def test_block_aggregation_matches_plain_and_pallas(name, D):
    """The emulated kernel (blocks of runs of 256 pixels) against the
    plain version and the Pallas scatter: one add per (face, plane) a
    block, so one face winning every pixel costs D adds a block, not D a
    pixel."""
    bs, size = 2, 48
    fim, nf = _map(name, bs, size)
    g = np.random.RandomState(D).randn(bs, D, size, size).astype(np.float32)
    got, adds = emulate_k3(g, fim, nf, seed=D)
    want = rc.scatter_pixels_to_faces_plain(torch.tensor(g), torch.tensor(fim), nf).numpy()
    _close(got, want)
    pallas = np.asarray(scatter_to_faces_pallas(jnp.asarray(g), jnp.asarray(fim), nf,
                                                interpret=True, planar=True, planar_out=True))
    _close(got, pallas)
    covered = int((fim >= 0).sum())
    blocks = bs * -(-size * size // THREADS)
    if name == "one face":
        assert adds == blocks * D
    elif name == "checkerboard":
        assert adds == covered * D          # every winner distinct within its block
    else:
        assert adds < covered * D / 3          # 256 pixels over 57 faces


@pytest.mark.parametrize("D", [6, 27, 36])
def test_one_row_of_pixels_as_runs_of_256(D):
    """H = 1, as K9's transpose calls K3 (one row of P pixels): the plain
    version's sums and the Pallas scatter's."""
    bs, nf, P = 2, 70, 1500
    rng = np.random.RandomState(D)
    fim = _soup_map(3, bs, nf, 40).reshape(bs, 1, -1)[:, :, :P]
    fim[:, :, ::97] = -1
    g = rng.randn(bs, D, 1, fim.shape[-1]).astype(np.float32)
    got, adds = emulate_k3(g, fim, nf, seed=D)
    want = rc.scatter_pixels_to_faces_plain(torch.tensor(g), torch.tensor(fim), nf).numpy()
    _close(got, want)
    pallas = np.asarray(scatter_to_faces_pallas(jnp.asarray(g), jnp.asarray(fim), nf,
                                                interpret=True, planar=True, planar_out=True))
    _close(got, pallas)
    assert adds < int((fim >= 0).sum()) * D


@pytest.mark.parametrize("tile_w", [16, 32, 256, None])
def test_tile_shapes_and_ids_outside_the_table(tile_w):
    """Every block shape (None: the kernel's runs of 256) gives the plain
    version's sums on a ragged canvas (blocks past the edges), and ids of -7, nf and nf + 5 add nothing, in
    the emulation and in the plain version alike."""
    bs, nf, H, W, D = 2, 40, 37, 45, 9
    rng = np.random.RandomState(tile_w or 1)
    # runs of three pixels along the rows
    fim = np.repeat(rng.randint(0, nf, (bs, H, -(-W // 3))), 3, axis=2)[..., :W]
    fim = np.ascontiguousarray(fim, dtype=np.int32)
    flat = fim.reshape(-1)
    flat[::7], flat[3::11], flat[5::13] = -7, nf, nf + 5
    g = rng.randn(bs, D, H, W).astype(np.float32)
    got, _ = emulate_k3(g, fim, nf, tile_w)
    want = rc.scatter_pixels_to_faces_plain(torch.tensor(g), torch.tensor(fim), nf).numpy()
    _close(got, want)
    inside = np.where((fim >= 0) & (fim < nf), fim, nf)
    exact = np.zeros((bs, D, nf + 1))
    for b in range(bs):
        for d in range(D):
            np.add.at(exact[b, d], inside[b].reshape(-1), g[b, d].reshape(-1).astype(np.float64))
    _close(want, exact[..., :nf].astype(np.float32))
