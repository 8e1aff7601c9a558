"""Run a function on several local ranks, each in a process of its own.

    results = run_ranks(fn, 2, args, device="cpu")

Each rank is a process started with ``multiprocessing``'s "spawn" method
(so ``fn`` must be importable: a module-level function), with the default
process group up (``distributed.initialize`` over a file store in a
temporary directory, so concurrent runs never share a port).  With
``device="cuda"`` each rank takes its own card over NCCL while there are
no more ranks than cards (more share them only with ``backend="gloo"``),
and the parent builds the kernels before it starts them, so that each
rank only loads the library.  The parent waits for them with a deadline;
when one fails or the deadline passes it kills the others and raises, so
a rank stuck in a collective cannot hang the caller.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from . import distributed


def _rank_main(fn, rank, world_size, workdir, device, backend, timeout):
    if device == "cpu":
        # the ranks share the host's cores: one pool of threads each would
        # oversubscribe them world_size-fold
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        distributed.initialize(f"file://{workdir}/store", world_size, rank, backend,
                               device=device, timeout=datetime.timedelta(seconds=timeout))
        with open(os.path.join(workdir, "args.pkl"), "rb") as fh:
            args = pickle.load(fh)
        result = fn(*args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    except BaseException:
        # whole or not at all: the parent reads it while this rank may
        # still be leaving its group (an NCCL group may never let it go)
        err = os.path.join(workdir, f"rank{rank}.err")
        with open(err + ".part", "w") as fh:
            fh.write(traceback.format_exc())
        os.replace(err + ".part", err)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _failures(procs, workdir):
    """Each failed rank's exit code and traceback.  A rank that wrote its
    traceback counts as failed while it is still exiting: the rank that
    failed first may be the last to exit, and a rank whose NCCL group
    waits on a peer may not exit at all."""
    out = []
    for rank, p in enumerate(procs):
        err = os.path.join(workdir, f"rank{rank}.err")
        if p.exitcode or os.path.exists(err):
            why = ""
            if os.path.exists(err):
                with open(err) as fh:
                    why = fh.read()
            out.append(f"rank {rank} of {len(procs)} failed (exit code {p.exitcode}):\n{why}")
    return "\n".join(out)


def run_ranks(fn, world_size, args=(), *, device="cuda", backend=None, timeout=300.0):
    """``fn(*args)`` on ranks 0 .. world_size - 1; returns their results in
    rank order.  ``device`` and ``backend`` as for
    :func:`distributed.initialize` (one rank per card takes NCCL; several
    ranks on one card need ``backend="gloo"``).  Raises RuntimeError, with
    the rank's traceback, when a rank fails, and TimeoutError when the
    ranks are not done within ``timeout`` seconds (also the limit of each
    collective of the default group)."""
    ctx = multiprocessing.get_context("spawn")
    if device == "cuda":
        from ..utils import cuda_build

        cuda_build.build()
    with tempfile.TemporaryDirectory() as workdir:
        # the arguments go through a file: through each rank's start-up pipe,
        # a large one would start the ranks one after another
        with open(os.path.join(workdir, "args.pkl"), "wb") as fh:
            pickle.dump(args, fh)
        procs = [ctx.Process(target=_rank_main, args=(fn, rank, world_size, workdir, device,
                                                      backend, timeout))
                 for rank in range(world_size)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            pending = list(procs)
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{len(pending)} of {world_size} ranks not done "
                                       f"within {timeout} s")
                # each second: a rank that failed may not exit
                multiprocessing.connection.wait([p.sentinel for p in pending], min(left, 1.0))
                pending = [p for p in pending if p.exitcode is None]
                if _failures(procs, workdir):
                    # the others fail in turn in the collective the failed rank
                    # left: give them a moment to say so, then report every one
                    multiprocessing.connection.wait([p.sentinel for p in pending], 1.0)
                    raise RuntimeError(_failures(procs, workdir))
        finally:
            for p in procs:
                if p.pid is not None:
                    if p.is_alive():
                        p.kill()
                    p.join()
        results = []
        for rank in range(world_size):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results
