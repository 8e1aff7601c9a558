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
``draw_backside`` values, on a ragged canvas and a row window.

The face stream's cluster design (``tools/resolve_designs.cu``, timed
against the shipped forms and not shipped: it measured slower) loads the
stream once for a cluster of C CTAs (a row of tiles): each batch's nine
runs of the planar ``fvp`` come by multicast bulk copies (run j from rank
j % C) into a ring of five stages, each run at its address's offset within
a 128-byte line in a slot of 288 floats, its unaligned head and tail read
from global memory by the threads whose faces they hold; a stage is
refilled once every CTA has released it.  The ring's indexing is emulated:
every CTA receives every face exactly once, in id order, from aligned
copies whose bytes the stage's barrier expects, for nf not a multiple of
4, under one batch and zero.
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
        counts = t.reshape(-1, 32).sum(1)
        offset = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lane = np.arange(BATCH) % 32
        warp = np.arange(BATCH) // 32
        before = np.array([t[w * 32:w * 32 + l].sum() for w, l in zip(warp, lane)])
        slot = offset[warp] + before
        total = int(counts.sum())
        staged_ids = np.full(total, -1)
        staged = np.zeros((17, total), f32)
        for k in np.flatnonzero(t):
            staged_ids[slot[k]] = e[k]
            for j in c:
                staged[j, slot[k]] = c[j][k]
            staged[9, slot[k]] = f32(1.0) / z0[k]
            staged[10, slot[k]] = f32(1.0) / z1[k]
            staged[11, slot[k]] = f32(1.0) / z2[k]
        ids.append(staged_ids)
        consts.append(staged)
    return np.concatenate(ids), np.concatenate(consts, axis=1)


def _faces(seed):
    """[bs, 3, 3, nf] planar faces: a soup over two staging batches with a
    duplicate, zero-area, NaN (x, y and z) and off-canvas faces; about half
    the soup faces backwards."""
    rng = np.random.RandomState(seed)
    bs, nf = 2, 300
    fv = rng.uniform(-1, 1, (bs, nf, 3, 3)).astype(f32)
    fv[..., :2] *= rng.uniform(0.05, 1.0, (bs, nf, 1, 1)).astype(f32)   # small and large
    fv[..., :2] += rng.uniform(-0.6, 0.6, (bs, nf, 1, 2)).astype(f32)
    fv[..., 2] = np.abs(fv[..., 2]) + f32(0.1)
    fv[:, 1] = fv[:, 0]                       # duplicate
    fv[:, 2, 1] = fv[:, 2, 0]                 # two vertices in one
    fv[:, 3, :, 0] = np.nan                   # NaN x
    fv[:, 4, 2, 1] = np.nan                   # NaN y
    fv[:, 5, 0, 2] = np.nan                   # NaN z: live, its depth NaN
    fv[:, 6, :, :2] += f32(3.0)               # off the canvas
    fv[:, 280] = fv[:, 7]                     # a duplicate in the second batch
    return np.ascontiguousarray(fv.transpose(0, 3, 2, 1))


@pytest.mark.parametrize("draw_backside", [True, False])
@pytest.mark.parametrize("size,window", [(40, (0, None)), (40, (7, 21)), (48, (0, None))])
def test_staging_selects_k1s_touching_faces_with_k1s_bits(size, window, draw_backside):
    fvp = _faces(size + 3 * window[0])
    consts = rc.face_setup_plain(torch.tensor(fvp), draw_backside).numpy()
    row_start, num_rows = window
    rows = size if num_rows is None else num_rows
    seen_killed = seen_nan = 0
    for b in range(fvp.shape[0]):
        c = consts[b]
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
                full_index, full_depth = resolve_constants(torch.tensor(c[None]), size, 0.1,
                                                           100.0, row_start=row_start + r0,
                                                           num_rows=th)
                index = index[0, :, c0:c0 + tw].numpy()
                mapped = np.where(index >= 0, ids[np.maximum(index, 0)], -1)
                np.testing.assert_array_equal(mapped, full_index[0, :, c0:c0 + tw].numpy())
                np.testing.assert_array_equal(depth[0, :, c0:c0 + tw].numpy(),
                                              full_depth[0, :, c0:c0 + tw].numpy())
        killed = (c[13] == 4.0) & (c[14] == -4.0)
        seen_killed += int(killed[[1, 2, 3, 4]].sum())
        seen_nan += int(np.isnan(c[9:12, 5]).any())
    # the duplicate (face 1) dies only without backsides, or wins nothing
    assert seen_killed >= 3 * fvp.shape[0] and seen_nan == fvp.shape[0]
    if not draw_backside:
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


# the cluster ring of tools/resolve_designs.cu: five stages, nine runs a
# batch, a run's slot of 288 floats (a batch and a 128-byte line)
STAGES, RUN_SLOT = 5, BATCH + 32


def _run_plan(addr, length):
    """run_plan: (q, a0, body) of a run starting at float address ``addr``
    (4-byte units) with ``length`` entries."""
    q = addr & 3
    a0 = (4 - q) & 3
    body = (length - a0) & ~3 if length > a0 else 0
    return q, a0, body


def _emulate_cluster(bs, nf, cluster, offset):
    """Every CTA of a cluster walking the batches of image b's face stream,
    the face vertices at float address ``offset`` + their index (the tensor
    at ``offset`` floats past a 16-byte boundary): the copies each rank
    issues, what lands in each CTA's ring, what each thread reads.
    Returns, for each image and CTA, the faces each thread took, in order,
    with their nine coordinates as read."""
    fvp = np.arange(bs * 9 * nf, dtype=np.int64)       # each float: its own index
    taken = {}
    for b in range(bs):
        vb = b * 9 * nf
        rings = np.full((cluster, STAGES, 9, RUN_SLOT), -1, dtype=np.int64)
        writes = np.zeros((cluster, STAGES, 9, RUN_SLOT), dtype=np.int64)
        got = {(rank, t): [] for rank in range(cluster) for t in range(BATCH)}
        batches = -(-nf // BATCH)
        pending = {}                                   # stage -> expected bytes
        landed = np.zeros((cluster, STAGES), dtype=np.int64)
        released = np.full((cluster, STAGES), cluster)  # empty barriers: arrivals

        def issue(i):
            stage, base = i % STAGES, i * BATCH
            length = min(BATCH, nf - base)
            plans = [_run_plan(offset + vb + j * nf + base, length) for j in range(9)]
            # every CTA's thread 0 expects the whole batch's bodies
            pending[stage] = sum(4 * body for _, _, body in plans)
            # a stage is refilled only once every CTA has released it
            assert (released[:, stage] == cluster).all()
            released[:, stage] = 0
            writes[:, stage] = 0
            landed[:, stage] = 0
            for rank in range(cluster):
                for j in range(rank, 9, cluster):
                    q, a0, body = plans[j]
                    if body == 0:
                        continue
                    src = offset + vb + j * nf + base + a0
                    line = (offset + vb + j * nf) % 32      # the run's offset in its line
                    dst = line + a0
                    # a bulk copy: 16-byte source, destination and size, the
                    # destination at the source's offset within a line
                    assert src % 4 == 0 and dst % 4 == 0 and (4 * body) % 16 == 0
                    assert dst % 32 == src % 32 and dst + body <= RUN_SLOT
                    for dest in range(cluster):            # multicast to every CTA
                        rings[dest, stage, j, dst:dst + body] = fvp[src - offset:
                                                                    src - offset + body]
                        writes[dest, stage, j, dst:dst + body] += 1
                        landed[dest, stage] += 4 * body

        for i in range(min(STAGES, batches)):
            issue(i)
        for i in range(batches):
            stage, base = i % STAGES, i * BATCH
            length = min(BATCH, nf - base)
            # the stage's barrier completes with exactly its expected bytes
            assert (landed[:, stage] == pending[stage]).all()
            assert writes[:, stage].max() <= 1
            for rank in range(cluster):
                for t in range(BATCH):
                    v = []
                    for j in range(9):
                        run = vb + j * nf + base
                        q, a0, body = _run_plan(offset + run, length)
                        if a0 <= t < a0 + body:
                            v.append(rings[rank, stage, j, (offset + run) % 32 + t])
                        else:
                            v.append(fvp[run + t] if t < length else -1)
                    if t < length:
                        got[rank, t].append((base + t, v))
                # this CTA has read the stage: it releases it to every CTA
                released[:, stage] += 1
            if i + STAGES < batches:
                issue(i + STAGES)
        taken[b] = got
    return taken


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("cluster", [2, 4, 8])
@pytest.mark.parametrize("nf", [1, 3, 255, 257, 2561])
def test_cluster_ring_delivers_every_face_to_every_cta_once_in_order(nf, cluster, offset):
    bs = 2
    taken = _emulate_cluster(bs, nf, cluster, offset)
    for b in range(bs):
        for rank in range(cluster):
            faces = []
            for t in range(BATCH):
                for f, v in taken[b][rank, t]:
                    assert f % BATCH == t
                    # fvp[b, coord, vertex, f] at (b * 9 + 3 * coord + vertex) * nf + f
                    assert v == [(b * 9 + j) * nf + f for j in range(9)]
                    faces.append(f)
            # every face once, and each thread's faces in ascending order
            assert sorted(faces) == list(range(nf))
            for t in range(BATCH):
                ids = [f for f, _ in taken[b][rank, t]]
                assert ids == sorted(ids)


def test_cluster_ring_with_no_faces_issues_nothing():
    taken = _emulate_cluster(2, 0, 4, 0)
    assert all(not v for got in taken.values() for v in got.values())


def test_cluster_ring_copies_most_of_each_run():
    """What the threads read from global memory: at most three floats at
    each end of a run, none when the run is aligned."""
    for nf in (257, 2561):
        for j in range(9):
            q, a0, body = _run_plan(j * nf, BATCH)
            assert a0 <= 3 and BATCH - a0 - body <= 3
            assert (q, a0, body) == ((j * nf) % 4, (4 - (j * nf) % 4) % 4, body)
    assert _run_plan(0, BATCH) == (0, 0, BATCH)
    assert _run_plan(1, 3) == (1, 3, 0)            # a run under 4 floats: no copy
