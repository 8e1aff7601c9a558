"""K8's staging (the binned forms in ``csrc/resolve.cu``), emulated in
numpy float32, against K1's and K7's plain versions.

K8 is a CTA of 64 threads per 8x8 bin.  The bin's entries are staged 64 at
a time, thread t taking entry base + t: its id and a gather of its face's
nine coordinates, from which it forms the 17 constants and the kill rule
itself (``csrc/face_constants.cuh``); while a batch resolves, the next
batch's coordinates and the batch after's ids load (ids, then
coordinates, then the constants: three batches in the pipeline).  The
emulation runs that pipeline as the kernel does and holds what each bin
stages to ``face_setup_plain``'s constants of ``bin_faces_plain``'s ids,
bit for bit and in order, and the fold over a bin's staged faces to the
plain resolve on its pixels.  The faces include degenerate, NaN,
backfacing and off-canvas ones, under both ``draw_backside`` values; bins
of 1 to 193 entries try the batch of 64 and the three-batch pipeline at
their edges.
"""

import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops.resolve import resolve_constants
from test_torch_tiled_staging import _constants_xy, _faces, _kill_invalid

f32 = np.float32
CTA = 64      # K8's threads, one per pixel of an 8x8 bin, and entries a batch


def _stage_entry(vb, f, draw_backside):
    """One lane's entry: face f's nine coordinates gathered from one image's
    planar faces ``vb`` [3, 3, nf], its 17 constants formed in float32."""
    x0, x1, x2, y0, y1, y2, z0, z1, z2 = (vb[j // 3, j % 3, f:f + 1] for j in range(9))
    c = _constants_xy(x0, y0, x1, y1, x2, y2)
    _kill_invalid(c, draw_backside)
    with np.errstate(divide="ignore", invalid="ignore"):
        c[9], c[10], c[11] = f32(1) / z0, f32(1) / z1, f32(1) / z2
    return np.array([c[j][0] for j in range(17)], dtype=f32)


def _emulate_ctas(fvp, draw_backside, bins):
    """Every bin's CTA: {bin: (ids, staged constants [17, k])}, in the order
    the batches were staged; each thread's pipeline as binned_kernel runs
    it (f: the batch's id, f1: the next batch's, whose coordinates load
    while this batch resolves, f2: the batch after's)."""
    cnt, off, ids = (t.reshape(-1).numpy() for t in bins)
    tiles, n = bins[0].shape[1], CTA
    staged = {}
    for g in range(len(cnt)):
        c, bin_ids = int(cnt[g]), ids[off[g]:off[g] + cnt[g]]
        vb = fvp[g // tiles]
        f = [int(bin_ids[t]) if t < c else -1 for t in range(n)]
        f1 = [int(bin_ids[n + t]) if n + t < c else -1 for t in range(n)]
        got_ids, got_c = staged.setdefault(g, ([], []))
        for base in range(0, c, n):
            f2 = [int(bin_ids[base + 2 * n + t]) if base + 2 * n + t < c else -1
                  for t in range(n)]
            for t in range(n):
                if f[t] >= 0:
                    got_ids.append(f[t])
                    got_c.append(_stage_entry(vb, f[t], draw_backside))
            assert sum(x >= 0 for x in f) == min(n, c - base)
            f, f1 = f1, f2
    return staged


def _covering(seed, entries, draw_backside):
    """[2, 3, 3, nf] planar faces of which every bin of the canvas holds
    exactly ``entries``: large faces over the whole canvas at seeded
    depths, the first of them backwards (held only with ``draw_backside``)
    and the second with a NaN z (live, its 1/z NaN); before, between and
    after them a zero-area, a NaN x and an off-canvas face, which no bin
    holds."""
    rng = np.random.RandomState(seed)
    bs, large = 2, entries + 1 - draw_backside
    front = np.array([[-3, -3], [7, -3], [-3, 7]], f32)
    fv = np.empty((bs, large, 3, 3), f32)
    fv[..., :2] = front + rng.uniform(-0.5, 0.5, (bs, large, 3, 2)).astype(f32)
    fv[..., 2] = rng.uniform(0.5, 3.0, (bs, large, 3)).astype(f32)
    fv[:, 0] = fv[:, 0, ::-1]                  # backwards
    if large > 1:
        fv[:, 1, 0, 2] = np.nan
    zero_area, nan_x, off = (rng.uniform(-0.5, 0.5, (bs, 1, 3, 3)).astype(f32)
                             for _ in range(3))
    zero_area[:, :, 1] = zero_area[:, :, 0]
    nan_x[:, :, 2, 0] = np.nan
    off[..., :2] += f32(3.0)
    half = large // 2
    fv = np.concatenate([zero_area, fv[:, :half], nan_x, fv[:, half:], off], 1)
    return np.ascontiguousarray(fv.transpose(0, 3, 2, 1))


@pytest.mark.parametrize("entries", [1, 63, 64, 65, 192, 193])
@pytest.mark.parametrize("draw_backside", [True, False])
@pytest.mark.parametrize("size,window", [(40, (0, None)), (40, (7, 21)), (24, (0, None))])
def test_cta_staging_gives_k1s_constants_of_k7s_ids(size, window, draw_backside, entries):
    """Bins of one entry, one under, at and past a batch of 64, and at and
    past three batches (the pipeline's depth)."""
    fvp = _covering(size + window[0], entries, draw_backside)
    t = torch.tensor(fvp)
    bins = rc.bin_faces_plain(t, draw_backside, size, *window)
    consts = rc.face_setup_plain(t, draw_backside).numpy()
    staged = _emulate_ctas(fvp, draw_backside, bins)
    cnt, off, ids = (x.reshape(-1).numpy() for x in bins)
    tiles = bins[0].shape[1]
    assert (cnt == entries).all()
    for g in range(len(cnt)):
        got_ids, got_c = staged[g]
        want = ids[off[g]:off[g] + cnt[g]]
        np.testing.assert_array_equal(np.array(got_ids, dtype=np.int32), want)
        # K1's constants to the bit (NaN payloads included)
        np.testing.assert_array_equal(np.stack(got_c, 1).view(np.uint32),
                                      consts[g // tiles][:, want].view(np.uint32))


@pytest.mark.parametrize("draw_backside", [True, False])
def test_folding_a_bins_staged_faces_gives_the_plain_resolve(draw_backside):
    """The sequential fold over each bin's staged faces alone is the plain
    resolve on the bin's pixels (thread t: row t // 8, column t % 8), on a
    ragged canvas and a row window."""
    size, (row_start, rows) = 44, (5, 30)
    fvp = _faces(9)
    t = torch.tensor(fvp)
    bins = rc.bin_faces_plain(t, draw_backside, size, row_start, rows)
    staged = _emulate_ctas(fvp, draw_backside, bins)
    full = rc.resolve_depth_plain(t, draw_backside, size, 0.1, 100.0, row_start, rows)
    th, tw = rc.BIN_TILE
    tiles_x, tiles = -(-size // tw), bins[0].shape[1]
    for g, (got_ids, got_c) in staged.items():
        b, tile = divmod(g, tiles)
        r0, c0 = (tile // tiles_x) * th, (tile % tiles_x) * tw
        h, w = min(th, rows - r0), min(tw, size - c0)
        want_index = full[0][b, r0:r0 + h, c0:c0 + w].numpy()
        if not got_ids:
            assert (want_index == -1).all()
            continue
        index, depth = resolve_constants(torch.tensor(np.stack(got_c, 1)[None]), size, 0.1,
                                         100.0, row_start=row_start + r0, num_rows=h)
        index = index[0, :, c0:c0 + w].numpy()
        mapped = np.where(index >= 0, np.array(got_ids)[np.maximum(index, 0)], -1)
        np.testing.assert_array_equal(mapped, want_index)
        np.testing.assert_array_equal(depth[0, :, c0:c0 + w].numpy(),
                                      full[1][b, r0:r0 + h, c0:c0 + w].numpy())
