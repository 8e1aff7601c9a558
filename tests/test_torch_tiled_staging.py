"""The tiled resolve forms' staging (K2, K2L, K2D in ``csrc/resolve.cu``),
emulated in numpy float32, against K1's plain version.

The tiled forms take the face vertices, not K1's constants.  A CTA of
16 x 16 pixels stages faces 256 at a time: each thread holds one face's
nine coordinates, tests a bbox of ``fminf`` / ``fmaxf`` (which drop a NaN)
against the tile's pixel-centre range, and for a face that passes forms
its x/y constants, exact bbox and det, applies the kill rule
(``csrc/face_constants.cuh``) and tests again; the batch is compacted in
order (a ballot per warp, a prefix over the warps), and the faces that
pass form 1/z.  The emulation does each step as written there and
holds what it stages, for every tile, to ``face_setup_plain``: exactly the
faces whose killed bbox touches the tile, in ascending order, with K1's
17 constants to the bit; and the sequential fold over those faces alone
gives the plain resolve's index and depth on the tile's pixels.  The faces
include degenerate, NaN, backfacing and off-canvas ones, under both
``draw_backside`` values, on a ragged canvas and a row window, in one
batch, at its edge (255, 256, 257 faces) and over several.
"""

import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops.resolve import resolve_constants

TILE = 16
BATCH = TILE * TILE
f32 = np.float32


def _centre(i, s):
    """pixel_centre of the kernel: (2.0f * i + 1.0f - s) / s."""
    return (f32(2.0) * f32(i) + f32(1.0) - f32(s)) / f32(s)


def _constants_xy(x0, y0, x1, y1, x2, y2):
    """face_constants.cuh's constants_xy over arrays: {index: values}."""
    C0 = x1 * y2 - x2 * y1
    C1 = x2 * y0 - x0 * y2
    C2 = x0 * y1 - x1 * y0
    # np.minimum / np.maximum propagate NaN, as min_nan / max_nan do
    return {0: x2 - x1, 1: y1 - y2, 2: C0, 3: x0 - x2, 4: y2 - y0, 5: C1, 6: x1 - x0,
            7: y0 - y1, 8: C2, 12: C0 + C1 + C2,
            13: np.minimum(np.minimum(x0, x1), x2), 14: np.maximum(np.maximum(x0, x1), x2),
            15: np.minimum(np.minimum(y0, y1), y2), 16: np.maximum(np.maximum(y0, y1), y2)}


def _kill_invalid(c, draw_backside):
    valid = np.abs(c[12]) >= f32(1e-8)               # False for a NaN det
    if not draw_backside:
        valid &= ~(c[4] * c[6] < c[7] * c[3])
    for j, v in zip(range(13, 17), (4.0, -4.0, 4.0, -4.0)):
        c[j] = np.where(valid, c[j], f32(v))
    return valid


def _stage(fv, draw_backside, lo_hi):
    """One CTA's staging over one image's planar faces ``fv`` [3, 3, nf]
    for a tile with pixel-centre range ``lo_hi`` = (x_lo, x_hi, y_lo, y_hi):
    (the staged face ids in slot order, their constants [17, n])."""
    nf = fv.shape[-1]
    x_lo, x_hi, y_lo, y_hi = lo_hi
    ids, consts = [], []
    for base in range(0, nf, BATCH):
        e = np.arange(base, min(base + BATCH, nf))
        (x0, x1, x2), (y0, y1, y2), (z0, z1, z2) = (fv[k][:, e] for k in range(3))
        # the first test, on bboxes that drop NaN (np.fmin / np.fmax, as
        # fminf / fmaxf), then the exact one after the kill rule
        first = ~((np.fmax(np.fmax(x0, x1), x2) < x_lo) | (x_hi < np.fmin(np.fmin(x0, x1), x2))
                  | (np.fmax(np.fmax(y0, y1), y2) < y_lo) | (y_hi < np.fmin(np.fmin(y0, y1), y2)))
        c = _constants_xy(x0, y0, x1, y1, x2, y2)
        _kill_invalid(c, draw_backside)
        touches = first & ~((c[14] < x_lo) | (x_hi < c[13]) | (c[16] < y_lo) | (y_hi < c[15]))
        # the ballot per warp and the prefix over warps: slot of each face
        t = np.zeros(BATCH, bool)
        t[:len(e)] = touches
        warps = t.reshape(-1, 32)
        counts = warps.sum(1)
        offset = np.concatenate([[0], np.cumsum(counts)[:-1]])
        # the lanes before each lane in its warp that pass (the ballot's
        # popcount below the lane)
        before = (np.cumsum(warps, 1) - warps).reshape(-1)
        slot = offset[np.arange(BATCH) // 32] + before
        total = int(counts.sum())
        staged_ids = np.full(total, -1)
        staged = np.zeros((17, total), f32)
        k = np.flatnonzero(t)
        staged_ids[slot[k]] = e[k]
        for j in c:
            staged[j, slot[k]] = c[j][k]
        staged[9, slot[k]] = f32(1.0) / z0[k]
        staged[10, slot[k]] = f32(1.0) / z1[k]
        staged[11, slot[k]] = f32(1.0) / z2[k]
        ids.append(staged_ids)
        consts.append(staged)
    return np.concatenate(ids), np.concatenate(consts, axis=1)


def _faces(seed, nf=300):
    """[bs, 3, 3, nf] planar faces: a soup with a duplicate, zero-area, NaN
    (x, y and z) and off-canvas faces (those of them that ``nf`` holds) and,
    past one staging batch, a duplicate in the second; about half the soup
    faces backwards."""
    rng = np.random.RandomState(seed)
    bs = 2
    fv = rng.uniform(-1, 1, (bs, nf, 3, 3)).astype(f32)
    fv[..., :2] *= rng.uniform(0.05, 1.0, (bs, nf, 1, 1)).astype(f32)   # small and large
    fv[..., :2] += rng.uniform(-0.6, 0.6, (bs, nf, 1, 2)).astype(f32)
    fv[..., 2] = np.abs(fv[..., 2]) + f32(0.1)
    if nf > 1:
        fv[:, 1] = fv[:, 0]                   # duplicate
    if nf > 2:
        fv[:, 2, 1] = fv[:, 2, 0]             # two vertices in one
    if nf > 6:
        fv[:, 3, :, 0] = np.nan               # NaN x
        fv[:, 4, 2, 1] = np.nan               # NaN y
        fv[:, 5, 0, 2] = np.nan               # NaN z: live, its depth NaN
        fv[:, 6, :, :2] += f32(3.0)           # off the canvas
    if nf > BATCH:
        fv[:, min(280, nf - 1)] = fv[:, 7]    # a duplicate in the second batch
    return np.ascontiguousarray(fv.transpose(0, 3, 2, 1))


@pytest.mark.parametrize("nf", [1, 3, 255, 256, 257, 300, 1031])
@pytest.mark.parametrize("draw_backside", [True, False])
@pytest.mark.parametrize("size,window", [(40, (0, None)), (40, (7, 21)), (48, (0, None))])
def test_staging_selects_k1s_touching_faces_with_k1s_bits(size, window, draw_backside, nf):
    fvp = _faces(size + 3 * window[0], nf)
    consts = rc.face_setup_plain(torch.tensor(fvp), draw_backside).numpy()
    row_start, num_rows = window
    rows = size if num_rows is None else num_rows
    seen_killed = seen_nan = 0
    for b in range(fvp.shape[0]):
        c = consts[b]
        full_index, full_depth = (t[0].numpy() for t in resolve_constants(
            torch.tensor(c[None]), size, 0.1, 100.0, row_start=row_start, num_rows=rows))
        for r0 in range(0, rows, TILE):
            for c0 in range(0, size, TILE):
                lo_hi = (_centre(c0, size), _centre(min(c0 + TILE, size) - 1, size),
                         _centre(row_start + r0, size),
                         _centre(row_start + min(r0 + TILE, rows) - 1, size))
                ids, staged = _stage(fvp[b], draw_backside, lo_hi)
                x_lo, x_hi, y_lo, y_hi = lo_hi
                want = np.flatnonzero(~((c[14] < x_lo) | (x_hi < c[13]) | (c[16] < y_lo)
                                        | (y_hi < c[15])))
                np.testing.assert_array_equal(ids, want)
                # K1's constants to the bit (NaN payloads included)
                np.testing.assert_array_equal(staged.view(np.uint32), c[:, ids].view(np.uint32))
                # the fold over the staged faces alone is the plain resolve
                # on the tile's pixels
                th, tw = min(TILE, rows - r0), min(TILE, size - c0)
                sub = torch.tensor(staged[None])
                index, depth = resolve_constants(sub, size, 0.1, 100.0,
                                                 row_start=row_start + r0, num_rows=th)
                index = index[0, :, c0:c0 + tw].numpy()
                # a tile that stages no face folds to the background
                mapped = np.where(index >= 0, ids[np.maximum(index, 0)], -1) if len(ids) \
                    else index
                np.testing.assert_array_equal(mapped, full_index[r0:r0 + th, c0:c0 + tw])
                np.testing.assert_array_equal(depth[0, :, c0:c0 + tw].numpy(),
                                              full_depth[r0:r0 + th, c0:c0 + tw])
        killed = (c[13] == 4.0) & (c[14] == -4.0)
        seen_killed += int(killed[2:5].sum())
        seen_nan += int(nf > 6 and np.isnan(c[9:12, 5]).any())
    # faces 2-4 die (face 2 where nf holds it); the duplicate (face 1) dies
    # only without backsides, or wins nothing
    bs = fvp.shape[0]
    assert seen_killed == bs * (3 if nf > 6 else nf > 2)
    assert seen_nan == bs * (nf > 6)
    if not draw_backside and nf > 6:
        assert (consts[:, 13] == 4.0).mean() > 0.3           # backfacing faces killed


def test_tiled_forms_take_face_vertices_and_match_the_binned_route():
    """The tiled wrappers' plain versions (K1's plain version, then the
    fold) against the binned route's (K7, K8, both from the face vertices)
    on the same faces: the same bits in all three forms and both backside
    modes."""
    fvp = torch.tensor(_faces(5))
    attrs = torch.tensor(np.random.RandomState(6).rand(2, 300, 4).astype(f32))
    for draw_backside in (True, False):
        args = (40, 0.1, 100.0, 5, 30)
        bins = rc.bin_faces(fvp, draw_backside, 40, 5, 30)
        pairs = [(rc.resolve_xy(fvp, draw_backside, *args),
                  rc.resolve_binned_xy(fvp, draw_backside, bins, *args)),
                 (rc.resolve_latch(fvp, attrs, draw_backside, *args),
                  rc.resolve_binned_latch(fvp, attrs, draw_backside, bins, *args)),
                 (rc.resolve_depth(fvp, draw_backside, *args),
                  rc.resolve_binned_depth(fvp, draw_backside, bins, *args))]
        for tiled, binned in pairs:
            for t, b in zip(tiled, binned):
                assert torch.equal(t, b)
        assert (pairs[0][0][0] >= 0).any()

