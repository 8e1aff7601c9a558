"""K7's passes (``csrc/bin_faces.cu``), emulated step by step on the CPU,
against its plain version ``bin_faces_plain`` (itself held to the JAX
package's ``_bin_faces`` by ``tests/test_torch_binned.py``).

The emulation follows the kernel: each face's bbox and K1's kill rule
formed from its screen coordinates (the plain K1, whose bits the kernel's
face_constants.cuh gives), its tile rectangle by the same pixel-centre
intervals, per-tile counters, their exclusive scan (padded to
the scan chunk), a fill through per-tile cursors in a seeded random order
(standing in for the atomics' order), then the order pass: a bin of at
most ``warp_cap`` ids ranked (each id's rank is the count of smaller
ids), a larger one through a bitmap of its id range [min, max] in windows
of ``32 * bitmap_words`` ids.  The kernel's caps are constants
(:data:`WARP_CAP`, :data:`BITMAP_WORDS`); the emulation also takes lowered
ones, so that a small mesh reaches the bitmap path in several windows.
Whatever order the fill took, the bins must be the plain version's, bit
for bit.  The capped form (the capacity a CUDA graph fixes) is emulated
too: the scan flags the bins whose pairs end past the capacity (offset -1,
counted), the fill writes only slots below it, and the order pass skips
the flagged bins; held to ``bin_faces_plain(capacity=...)``.  The card holds the kernel itself to the same bins
(``tests/test_torch_cuda.py``, where a crowded bin of real size takes two
bitmap windows).
"""

import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import icosphere

# K7's order pass (csrc/bin_faces.cu): a warp ranks a bin of at most
# kWarpCap ids; a larger one goes through bitmap windows of kBitmapWords
WARP_CAP, BITMAP_WORDS = 256, 4096


def _soup(seed, bs, nf):
    rng = np.random.RandomState(seed)
    fv = rng.uniform(-1, 1, size=(bs, nf, 3, 3)).astype("float32")
    fv[..., 2] = np.abs(fv[..., 2]) + 0.3
    fv[:, 5] = fv[:, 3]          # duplicate face
    fv[:, 7, 1] = fv[:, 7, 0]    # degenerate edge
    return fv


def _fvp(fv):
    return torch.tensor(np.ascontiguousarray(fv.transpose(0, 3, 2, 1)))


def _crowded(size, centre_px, radius_px):
    """icosphere(3) (1,280 faces) drawn into a few pixels around pixel
    ``centre_px`` (x, y) of a ``size``^2 canvas: [1, nf, 3, 3] NDC face
    vertices."""
    v, f = icosphere(3)
    v = v / np.abs(v).max()
    cx, cy = ((2.0 * np.asarray(centre_px) + 1.0 - size) / size)
    r = 2.0 * radius_px / size
    ndc = np.stack([cx + r * v[:, 0], cy + r * v[:, 1], 2.0 + v[:, 2]], -1).astype(np.float32)
    return ndc[f][None]


def _emulated_bins(fvp, draw_backside, size, row_start, num_rows, warp_cap, bitmap_words,
                   seed, capacity=None):
    """(cnt, offsets, ids, paths): the kernel's four passes in numpy;
    ``paths`` counts the bins each order path took, the bitmap windows and
    the overflow bins.  ``capacity`` None: the eager form, whose capacity
    is the pair total read back."""
    # each pass forms the bbox and the kill rule from the coordinates
    c = rc.face_setup_plain(fvp, draw_backside).numpy()
    bs, _, nf = c.shape
    rows = size if num_rows is None else num_rows
    th, tw = rc.BIN_TILE
    tiles_x, tiles_y = -(-size // tw), -(-rows // th)
    n_tiles = tiles_x * tiles_y
    f32 = np.float32

    def centre(i):
        return (f32(2) * i.astype(f32) + f32(1) - f32(size)) / f32(size)

    def interval(vmin, vmax, n, t, start, extent):
        # [first, end): first = tiles whose last centre < vmin, end = tiles
        # whose first centre <= vmax (tile_interval's binary searches)
        k = np.arange(n)
        lo = centre(start + k * t)
        hi = centre(start + np.minimum((k + 1) * t, extent) - 1)
        return (hi[None] < vmin[:, None]).sum(1), (lo[None] <= vmax[:, None]).sum(1)

    # 1. count: one face's rectangle, one count per covered tile
    pairs = []                                   # (bin, face), as each face's thread walks
    for b in range(bs):
        x0, x1 = interval(c[b, 13], c[b, 14], tiles_x, tw, 0, size)
        y0, y1 = interval(c[b, 15], c[b, 16], tiles_y, th, row_start, rows)
        for f in range(nf):
            if x1[f] > x0[f] and y1[f] > y0[f]:
                pairs += [(b * n_tiles + ty * tiles_x + tx, f)
                          for ty in range(y0[f], y1[f]) for tx in range(x0[f], x1[f])]
    padded = -(-bs * n_tiles // rc.BIN_SCAN_TILE) * rc.BIN_SCAN_TILE
    counters = np.zeros(padded, np.int64)
    for bin_, _ in pairs:
        counters[bin_] += 1
    # 2. the pair total, read back as the capacity (eager form); the fill's
    # scan: offsets and cursors, and the flags of the bins whose pairs end
    # past the capacity
    total = int(counters.sum())
    assert total == len(pairs)
    capacity = total if capacity is None else capacity
    offsets = np.cumsum(counters) - counters
    cursors = offsets.copy()
    flagged = offsets + counters > capacity
    flagged[bs * n_tiles:] = False                  # the padding is no bin
    # 3. fill: the atomics' order, here a seeded permutation of every pair;
    # only slots below the capacity are written
    unsorted = np.full(capacity, -1)
    for i in np.random.RandomState(seed).permutation(total):
        bin_, f = pairs[i]
        if cursors[bin_] < capacity:
            unsorted[cursors[bin_]] = f
        cursors[bin_] += 1
    # 4. order, of the bins that fit
    ids = np.full(capacity, -1)
    paths = {"warp": 0, "bitmap": 0, "windows": 0, "overflow": int(flagged.sum())}
    for bin_ in range(bs * n_tiles):
        o, k = offsets[bin_], counters[bin_]
        if flagged[bin_]:
            continue
        s = unsorted[o:o + k]
        if k <= warp_cap:
            paths["warp"] += k > 0
            for v in s:
                ids[o + (s < v).sum()] = v
            continue
        paths["bitmap"] += 1
        run = 0
        lo, hi = int(s.min()), int(s.max())
        for base in range(lo, hi + 1, 32 * bitmap_words):
            words = min(bitmap_words, (hi - base) // 32 + 1)
            bits = np.zeros(32 * words, bool)
            v = s - base
            bits[v[(v >= 0) & (v < 32 * words)]] = True
            found = base + np.flatnonzero(bits)
            ids[o + run:o + run + len(found)] = found
            run += len(found)
            paths["windows"] += 1
    fit = int(counters[:bs * n_tiles][~flagged[:bs * n_tiles]].sum())
    assert not (ids[:fit] < 0).any() and (ids[fit:] < 0).all()
    cnt = counters[:bs * n_tiles].reshape(bs, n_tiles)
    offsets = np.where(flagged, -1, offsets)[:bs * n_tiles].reshape(bs, n_tiles)
    return cnt, offsets, ids, paths


def _assert_plain_bins(fvp, size, window, warp_cap=WARP_CAP, bitmap_words=BITMAP_WORDS,
                       seed=0, draw_backside=True, capacity=None):
    cnt, offsets, ids, paths = _emulated_bins(fvp, draw_backside, size, *window, warp_cap,
                                              bitmap_words, seed, capacity)
    want = rc.bin_faces_plain(fvp, draw_backside, size, *window, capacity=capacity)
    np.testing.assert_array_equal(cnt, want[0].numpy())
    np.testing.assert_array_equal(offsets, want[1].numpy())
    np.testing.assert_array_equal(ids, want[2].numpy())
    if capacity is not None:
        assert int(want[3]) == paths["overflow"]
    return paths


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("size,window", [(64, (0, None)), (100, (37, 41)), (128, (0, None))])
def test_emulated_passes_give_the_plain_bins(size, window, seed):
    for backside in (True, False):
        paths = _assert_plain_bins(_fvp(_soup(seed + 3, 2, 90)), size, window, seed=seed,
                                   draw_backside=backside)
        assert paths["warp"] > 0


@pytest.mark.parametrize("seed", [5, 6])
def test_emulated_passes_on_a_lowered_warp_cap_give_the_plain_bins(seed):
    """The soup's larger bins through the bitmap, in windows of 32 ids."""
    paths = _assert_plain_bins(_fvp(_soup(seed, 2, 90)), 64, (0, None), warp_cap=4,
                               bitmap_words=1, seed=seed)
    assert paths["bitmap"] > 0 and paths["windows"] > paths["bitmap"]


def test_emulated_passes_on_an_empty_mesh_and_killed_faces():
    empty = torch.zeros((1, 3, 3, 0))
    paths = _assert_plain_bins(empty, 64, (0, None))
    assert set(paths.values()) == {0}
    # faces the kill rule drops: zero area (two vertices in one), NaN
    # coordinates, and, without draw_backside, the backfacing half
    fv = _soup(6, 1, 20)
    fv[:, :8, 1] = fv[:, :8, 0]
    fv[:, 8:10, :, :2] = np.nan
    killed = _fvp(fv)
    for backside in (True, False):
        _assert_plain_bins(killed, 64, (0, None), draw_backside=backside)
    assert (rc.face_setup_plain(killed, True)[0, 13, :10] == 4.0).all()
    assert int(rc.bin_faces_plain(killed[..., :10].contiguous(), True, 64)[0].sum()) == 0
    assert 0 < int(rc.bin_faces_plain(killed, False, 64)[0].sum()) < int(
        rc.bin_faces_plain(killed, True, 64)[0].sum())


@pytest.mark.parametrize("window", [(0, None), (56, 16)])
@pytest.mark.parametrize("centre", [(59.5, 59.5), (3.5, 60.5)])
def test_emulated_passes_on_a_crowded_tile(centre, window):
    """Every face of a small icosphere that K1 keeps (those seen edge-on
    are degenerate at this size) in one bin, in the canvas or at its edge,
    far above a lowered warp cap: the bitmap path, in five windows of 256
    ids, gives the plain bin; the kernel's caps (one window of 4096 words)
    too."""
    fvp = _fvp(_crowded(128, centre, 1.5))
    consts = rc.face_setup_plain(fvp, True)
    cnt = rc.bin_faces_plain(fvp, True, 128, *window)[0]
    alive = int((consts[:, 13] <= consts[:, 14]).sum())
    assert int(cnt.max()) == alive > 1200 and consts.shape[-1] == 1280
    paths = _assert_plain_bins(fvp, 128, window, warp_cap=32, bitmap_words=8, seed=2)
    assert paths["bitmap"] >= 1 and paths["windows"] == 5 * paths["bitmap"]
    paths = _assert_plain_bins(fvp, 128, window, seed=3)
    assert paths["windows"] == paths["bitmap"] >= 1


@pytest.mark.parametrize("scene", ["soup", "crowded", "crowded window", "empty"])
def test_emulated_capped_passes_give_the_plain_flags(scene):
    """The capped form at capacities 0 (every bin with a face overflows),
    under the total, half of it and the total (none overflows): the plain
    version's flags, counts and bins that fit; on a crowded tile (its one
    large bin through the bitmap) and an empty mesh."""
    fvp, size, window = {
        "soup": (_fvp(_soup(4, 2, 90)), 100, (37, 41)),
        "crowded": (_fvp(_crowded(128, (59.5, 59.5), 1.5)), 128, (0, None)),
        "crowded window": (_fvp(_crowded(128, (3.5, 60.5), 1.5)), 128, (56, 16)),
        "empty": (torch.zeros((1, 3, 3, 0)), 64, (0, None)),
    }[scene]
    cnt = rc.bin_faces_plain(fvp, True, size, *window)[0].reshape(-1)
    total = int(cnt.sum())
    for k, capacity in enumerate(sorted({0, max(total - 1, 0), total // 2, total})):
        paths = _assert_plain_bins(fvp, size, window, warp_cap=32, bitmap_words=8, seed=k,
                                   capacity=capacity)
        # the overflow bins: from the first whose pairs end past the capacity on
        ends = torch.cumsum(cnt, 0)
        assert paths["overflow"] == int((ends > capacity).sum())
        if capacity == 0:
            assert paths["overflow"] == len(cnt) - int((ends == 0).sum())
    assert (int(cnt.numpy().max(initial=0)) > 1200) == scene.startswith("crowded")
    assert (total == 0) == (scene == "empty")
