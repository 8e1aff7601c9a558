"""Process-group initialisation and the global mesh (counterpart of
``neural_renderer_v2_pytorch_tpu/parallel/distributed.py``).

One call of :func:`initialize` per rank, then a mesh over every rank::

    from neural_renderer_v2_pytorch_tpu_torch.parallel import distributed
    distributed.initialize()                          # False outside a cluster
    mesh = distributed.global_mesh(data=2, face=2)    # tile = the rest

Backends: NCCL when each rank has a card of its own; gloo for ranks on the
CPU, and gloo when the caller names it, which is the only way to put
several ranks on one card (NCCL refuses two ranks on one device; the
collectives then go through host memory, see ``parallel.collectives``).
An NCCL rank is bound to its card before the group comes up
(``device_id``), so that the default group's communicator is made at once
and the mesh's groups are split from it; a CUDA graph then holds its
collectives (``ops.graphs.Chain``).  An NCCL group that does not come up
raises: nothing falls back to gloo.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT, make_mesh

_CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _backend(device, backend, world_size, rank):
    """(backend, card) for this rank: the card is ``LOCAL_RANK`` (else
    ``rank``) modulo the cards, None on the CPU.  Without a named backend,
    NCCL, which takes one rank per card: more ranks on a host
    (``LOCAL_WORLD_SIZE``, else ``world_size``) than cards raise."""
    if device == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"ranks on the CPU take the gloo backend, not {backend!r}")
        return "gloo", None
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    cards = torch.cuda.device_count()
    card = int(os.environ.get("LOCAL_RANK", rank)) % cards
    if backend is None:
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if local_ranks > cards:
            raise ValueError(f"{local_ranks} ranks share {cards} card(s): NCCL takes one rank "
                             f"per card; pass backend='gloo' to share them")
        backend = "nccl"
    return backend, card


def initialize(init_method=None, world_size=None, rank=None, backend=None, *, device="cuda",
               timeout=DEFAULT_TIMEOUT):
    """Initialise the default process group.  Returns True when it is up.

    With no arguments the call is best-effort: it reads the cluster from the
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    as torchrun sets them) and returns False where there is none or a gloo
    group does not come up.  With explicit arguments, or on NCCL, a failure
    raises: rendering on one rank when a cluster was asked for would give
    wrong results with no signal.

    ``device``: "cuda" (each rank takes its card, see the module note; no
    CUDA raises) or "cpu".  ``timeout`` bounds each collective's wait."""
    if dist.is_initialized():
        return True
    explicit = not (init_method is None and world_size is None and rank is None)
    if not explicit and not all(k in os.environ for k in _CLUSTER_ENV):
        return False
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    backend, card = _backend(device, backend, world_size, rank)
    bound = {}
    if card is not None:
        torch.cuda.set_device(card)
        if backend == "nccl":
            bound["device_id"] = torch.device("cuda", card)
    try:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank, timeout=timeout, **bound)
    except (RuntimeError, ValueError):
        if explicit or backend == "nccl":
            raise
        return False
    return True


def global_mesh(data=1, tile=None, face=1):
    """A (data, tile, face) mesh over every rank (``tile`` = the rest), face
    innermost, so that the face combine's all-gathers stay among
    neighbouring ranks."""
    return make_mesh(data, tile, face)
