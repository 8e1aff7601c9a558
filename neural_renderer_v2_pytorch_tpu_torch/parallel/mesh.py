"""The (data, tile, face) rank mesh (counterpart of
``neural_renderer_v2_pytorch_tpu/parallel/mesh.py``).

  * ``data``: the batch; a rank renders its slice of the images.
  * ``tile``: image rows; a rank renders a band of rows
    (``parallel.render.band_rows``).
  * ``face``: the resolve's face loop (``parallel.faces``); a rank resolves
    a range of the faces and the winners fold across the axis.

Ranks are laid out as the JAX package lays out devices,
``ranks.reshape(data, tile, face)``: face innermost, so rank r sits at
``((d * tile + t) * face + f)``.  Each axis has one process group per line
of the mesh; ``Mesh.groups[axis]`` is this rank's.  ``Mesh.groups["cells"]``
holds the ranks at this rank's face coordinate, one per (data, tile) cell:
the sharded entry gathers its finished images over it.
``Mesh.groups["all"]`` holds every rank: the sharded entry sums its
gradients over it.

On NCCL a group's communicator may be made at its first collective, and
none can be made inside a CUDA graph capture.  The invariant: a group's
first collective runs eagerly, never in a capture.  The first call of a
sharded signature runs eagerly and issues every collective of the rank's
step, on every group that crosses ranks, before the second call captures
them; ``collectives.captured`` checks it and raises on a group that has
run none.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch.distributed as dist

AXES = ("data", "tile", "face")
# how long a collective of the mesh's groups (and of the default group that
# parallel.distributed.initialize makes) may wait for the other ranks
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, tile, face) mesh: ``shape`` and
    ``coords`` map each axis to its size and to this rank's index;
    ``groups`` maps each axis, "cells" and "all" to this rank's process
    group."""

    shape: dict
    coords: dict
    groups: dict


def _groups(lines):
    """One process group per row of ``lines`` (every rank makes every group,
    in the same order); returns the one that holds this rank."""
    rank, mine = dist.get_rank(), None
    for ranks in lines.tolist():
        group = dist.new_group(ranks, timeout=DEFAULT_TIMEOUT)
        if rank in ranks:
            mine = group
    return mine


def make_mesh(data=1, tile=None, face=1):
    """A (data, tile, face) mesh over every rank of the default process group
    (``parallel.distributed.initialize`` first).  ``tile`` defaults to the
    ranks left over; ``data * tile * face`` must be the world size.  Every
    collective of the mesh's groups waits at most :data:`DEFAULT_TIMEOUT`."""
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call parallel.distributed.initialize")
    n = dist.get_world_size()
    if tile is None:
        if n % (data * face):
            raise ValueError(f"{n} ranks do not divide into data={data} x face={face}")
        tile = n // (data * face)
    if data * tile * face != n:
        raise ValueError(f"a ({data}, {tile}, {face}) mesh needs {data * tile * face} ranks; "
                         f"the process group has {n}")
    grid = np.arange(n).reshape(data, tile, face)
    coords = dict(zip(AXES, (int(c) for c in np.argwhere(grid == dist.get_rank())[0])))
    groups = {axis: _groups(np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i]))
              for i, axis in enumerate(AXES)}
    groups["cells"] = _groups(np.moveaxis(grid, 2, 0).reshape(face, -1))
    groups["all"] = dist.group.WORLD
    return Mesh(dict(zip(AXES, (data, tile, face))), coords, groups)


# The JAX package's constant: past ~10K faces per device its resolve's face
# loop outweighed the pixel-bound stages.  Not measured on an H100; the rule
# only repeats the JAX package's meshes.
FACE_AXIS_CROSSOVER = 10_000


def auto_mesh_shape(n, num_faces=None):
    """The (data, tile, face) sizes :func:`auto_mesh` gives ``n`` ranks:
    tile first; a data axis of 2 from 8 ranks on; and with the face count
    known, every doubling of the face axis that leaves each rank at least
    :data:`FACE_AXIS_CROSSOVER` faces."""
    data = 2 if n >= 8 and n % 2 == 0 else 1
    rem = n // data
    face = 1
    if num_faces is not None:
        while (face * 2 <= rem and rem % (face * 2) == 0
               and num_faces // (face * 2) >= FACE_AXIS_CROSSOVER):
            face *= 2
    return data, rem // face, face


def auto_mesh(n_devices=None, num_faces=None):
    """The JAX package's heuristic mesh over the default process group's
    ranks (``n_devices``, when given, must be their number)."""
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"auto_mesh over {n_devices} ranks; the process group has {n}")
    data, tile, face = auto_mesh_shape(n, num_faces)
    return make_mesh(data, tile, face)
