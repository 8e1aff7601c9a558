"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all started
together, into an object file; the objects link into one shared library
with a plain C interface, loaded through ``ctypes``.  No PyTorch headers are
involved, so a build takes seconds.  The library lands in
``build/nr_torch_kernels/`` at the repository root, under a file name keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  A failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    # no multiply-add contraction: the resolve must round every product
    # and sum as the plain version does (and no --use_fast_math, which
    # would also make division approximate)
    "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nr_torch_kernels"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "nr_face_setup": (_P, _P, _I, _I, _I, _P),
    "nr_resolve_xy": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    "nr_resolve_latch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    "nr_resolve_depth": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    "nr_resolve_binned_xy": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                             _P),
    "nr_resolve_binned_latch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _F, _F, _P),
    "nr_resolve_binned_depth": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    "nr_resolve_latch_limits": (_I, _P, _P, _P),
    "nr_bin_faces_count": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "nr_bin_faces": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "nr_scatter_pixels_to_faces": (_P, _P, _P, _I, _I, _I, _I, _P),
    "nr_scatter_faces_to_vertices": (_P, _P, _P, _I, _I, _I, _P),
    "nr_gather_faces3": (_P, _P, _P, _I, _I, _I, _I, _P),
    "nr_gather_rows": (_P, _P, _P, _I, _I, _I, _I, _L, _I, _P),
    "nr_scatter_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnr_torch_kernels_{h.hexdigest()[:16]}.so"


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds):
    """Run the commands concurrently; raise on the first that fails.
    Returns their stderr, joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def build():
    """Compile the kernels unless the keyed library exists.  Returns
    ``(path, seconds, compiler_log)``; ``seconds`` is 0 for a cached build."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [os.path.join(work, src.stem + ".o") for src in sources()]
        t0 = time.perf_counter()
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for obj, src in zip(objs, sources())])
        lib = os.path.join(work, "lib.so")
        log += _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        seconds = time.perf_counter() - t0
        os.replace(lib, path)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path, seconds, log


def load():
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
