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
backfacing and off-canvas ones, under both ``draw_backside`` values.

The warp-per-bin design timed against it (``tools/resolve_designs.cu``:
one warp per bin, persistent warps walking the bins 32 entries at a time,
by a static stride or an atomic counter) is emulated as well: every bin
resolved and written once, with its own entries.
"""

import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops.resolve import resolve_constants
from test_torch_tiled_staging import _constants_xy, _faces, _kill_invalid

f32 = np.float32
CTA = 64      # K8's threads, one per pixel of an 8x8 bin, and entries a batch
LANES = 32    # the warp-per-bin design's entries a unit


class _Walk:
    """BinWalk: the next bin a warp starts, and its count and offset."""

    def __init__(self, first, cnt, off, stride, take):
        self.next, self.cnt, self.off, self.stride, self.take = first, cnt, off, stride, take
        self.load()

    def load(self):
        ok = self.next < len(self.cnt)
        self.n = int(self.cnt[self.next]) if ok else 0
        self.o = int(self.off[self.next]) if ok else 0

    def after(self, u):
        g, base, n, off = u
        if g >= len(self.cnt):
            return u
        if base + LANES < n:
            return (g, base + LANES, n, off)
        v = (self.next, 0, self.n, self.o)
        self.next = self.take(self.next, self.stride)
        self.load()
        return v


def _entry_ids(u, ids, n_bins):
    g, base, n, off = u
    return [int(ids[off + base + lane]) if g < n_bins and base + lane < n else -1
            for lane in range(LANES)]


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


def _warp(w, fvp, draw_backside, bins, warps, take, staged, written):
    """One warp's walk over the bins, as a generator that yields after each
    unit it resolves: the staged ids and constants of each bin into
    ``staged``, the bins in the order it writes them into ``written``."""
    cnt, off, ids = (t.reshape(-1).numpy() for t in bins)
    n_bins, tiles = len(cnt), bins[0].shape[1]
    walk = _Walk(w, cnt, off, warps, take)
    u0 = walk.after((-1, 0, 0, 0))
    u1 = walk.after(u0)
    id0, id1 = _entry_ids(u0, ids, n_bins), _entry_ids(u1, ids, n_bins)
    while u0[0] < n_bins:
        u2 = walk.after(u1)
        id2 = _entry_ids(u2, ids, n_bins)
        g, base, n, _ = u0
        vb = fvp[g // tiles]
        count = min(LANES, n - base)
        assert [f for f in id0 if f >= 0] == id0[:max(count, 0)]
        got_ids, got_c = staged.setdefault(g, ([], []))
        for lane in range(max(count, 0)):
            got_ids.append(id0[lane])
            got_c.append(_stage_entry(vb, id0[lane], draw_backside))
        if base + LANES >= n:
            written.append(g)
        u0, id0, u1, id1 = u1, id1, u2, id2
        yield


def _emulate_warps(fvp, draw_backside, bins, warps, take, rng=None):
    """Every warp's walk over the bins, one unit at a time, the warps in
    turn (or in a seeded random order): {bin: (ids, staged constants)} and
    the order the bins were written."""
    staged, written = {}, []
    running = [_warp(w, fvp, draw_backside, bins, warps, take, staged, written)
               for w in range(warps)]
    while running:
        k = int(rng.randint(len(running))) if rng is not None else 0
        try:
            next(running[k])
            if rng is None:
                running.append(running.pop(k))
        except StopIteration:
            running.pop(k)
    return staged, written


def _static(g, stride):
    return g + stride


def _counter():
    """The atomic counter: each take returns the next bin after the first
    ``stride`` (one per warp), in the order the warps reach it."""
    state = {"k": 0}

    def take(g, stride):
        state["k"] += 1
        return stride + state["k"] - 1
    return take


@pytest.mark.parametrize("draw_backside", [True, False])
@pytest.mark.parametrize("size,window", [(40, (0, None)), (40, (7, 21)), (24, (0, None))])
def test_cta_staging_gives_k1s_constants_of_k7s_ids(size, window, draw_backside):
    fvp = _faces(size + window[0])
    t = torch.tensor(fvp)
    bins = rc.bin_faces_plain(t, draw_backside, size, *window)
    consts = rc.face_setup_plain(t, draw_backside).numpy()
    staged = _emulate_ctas(fvp, draw_backside, bins)
    cnt, off, ids = (x.reshape(-1).numpy() for x in bins)
    tiles = bins[0].shape[1]
    crowded = 0
    for g in range(len(cnt)):
        got_ids, got_c = staged[g]
        want = ids[off[g]:off[g] + cnt[g]]
        np.testing.assert_array_equal(np.array(got_ids, dtype=np.int32), want)
        if len(want):
            got_c = np.stack(got_c, 1)
            # K1's constants to the bit (NaN payloads included)
            np.testing.assert_array_equal(got_c.view(np.uint32),
                                          consts[g // tiles][:, want].view(np.uint32))
        crowded += cnt[g] > CTA      # a bin of more than one batch
    assert crowded > 0 and int(cnt.sum()) > 0


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


@pytest.mark.parametrize("take", ["static", "counter"])
def test_warp_walk_design_takes_every_bin_once(take):
    """The warp-per-bin design: by a static stride (warps in turn) or an
    atomic counter (whatever order the warps reach it in: a seeded random
    order of their units), every bin is resolved and written once, with
    its own entries in order."""
    fvp = _faces(1)
    bins = rc.bin_faces_plain(torch.tensor(fvp), True, 40)
    if take == "static":
        staged, written = _emulate_warps(fvp, True, bins, 3, _static)
    else:
        staged, written = _emulate_warps(fvp, True, bins, 3, _counter(),
                                         np.random.RandomState(0))
    cnt, off, ids = (x.reshape(-1).numpy() for x in bins)
    assert sorted(written) == list(range(len(cnt)))
    for g in written:
        np.testing.assert_array_equal(np.array(staged[g][0], dtype=np.int32),
                                      ids[off[g]:off[g] + cnt[g]])
