"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all started
together, into an object file; the objects link into one shared library
with a plain C interface, loaded through ``ctypes``.  No PyTorch headers are
involved, so a build takes seconds.  Every kernel's C entry takes two
arguments, a block of int64 argument slots and the stream
(``csrc/nr_entry.cuh``); :data:`SIGNATURES` says what each slot holds and
:data:`PACKERS` packs a block.  The library lands in
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
import struct
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

# each kernel entry's arguments, one int64 slot each after the card's: P a
# pointer, i an int, q a long long, f a float (the bits of a double, which
# the entry rounds to float as a C call's float argument would be)
SIGNATURES = {
    "face_setup": "PPiii",
    "resolve_xy": "PPPPiiiiiiff",
    "resolve_latch": "PPPPPPiiiiiiiff",
    "resolve_depth": "PPPiiiiiiff",
    "resolve_binned_xy": "PPPPPPPiiiiiiff",
    "resolve_binned_latch": "PPPPPPPPPiiiiiiiff",
    "resolve_binned_depth": "PPPPPPiiiiiiff",
    "bin_faces_count": "PPiiiiii",
    "bin_faces": "PPPPPPiiiiiiiP",
    "scatter_pixels_to_faces": "PPPiiii",
    "scatter_faces_to_vertices": "PPPPiii",
    "gather_faces3": "PPPiiii",
    "gather_rows": "PPPiiiiqi",
    "atlas_taps_grad": "PPPiiii",
    "nmr_planes": "PPPPPPPiiiq",
    "nmr_planes_vjp": "PPPPPPiiiq",
    "nmr_coordinate_grad": "PPPPPPPiiiiqqqqf",
    "atlas_sample": "PPPPPPiiiiqqqqqqqf",
    "atlas_sample_vjp": "PPPPPPPPPPiiiiqqqqqqqf",
    "lights_shade": "PPPPPiiiqqqqqqqqq",
    "lights_shade_vjp": "PPPPPPPPiiiqqqqqqqqq",
}
# entry -> the struct that packs the card and the arguments into a block
PACKERS = {name: struct.Struct("<q" + "".join("d" if c == "f" else "q" for c in sig))
           for name, sig in SIGNATURES.items()}

_lock = threading.Lock()
_lib = None
# "face_setup" -> the loaded ``nr_face_setup(const long long* args, void*
# stream)``, and so on for every entry of SIGNATURES: filled once by load(),
# read by the wrappers without the lock
ENTRIES = {}


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):      # the sources and their headers
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
            for name in SIGNATURES:
                fn = getattr(lib, "nr_" + name)
                # the block as the bytes a wrapper packed (passed without a
                # copy), and the stream
                fn.argtypes = (ctypes.c_char_p, ctypes.c_void_p)
                fn.restype = ctypes.c_int
                ENTRIES[name] = fn
            limits = lib.nr_resolve_latch_limits
            limits.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
            limits.restype = ctypes.c_int
            _lib = lib
        return _lib
