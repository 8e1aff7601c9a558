"""ctypes bindings of the C++ OBJ geometry parser (``csrc/objparse.cpp``),
the counterpart of ``neural_renderer_v2_pytorch_tpu/utils/native_loader.py``.

The library is built with ``g++`` at first use into ``build/nr_torch_objparse/``
at the repository root, under a file name keyed by a hash of the source, and
loaded through ctypes.  Where it cannot be built or loaded, :func:`get_lib`
returns None and ``load_obj`` parses in Python, with the same result.  This
is host parsing; no device work is involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "objparse.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nr_torch_objparse"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_failed = False


class _NrObjMesh(ctypes.Structure):
    _fields_ = [
        ("vertices", ctypes.POINTER(ctypes.c_float)),
        ("num_vertices", ctypes.c_long),
        ("faces", ctypes.POINTER(ctypes.c_int)),
        ("num_faces", ctypes.c_long),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("num_uvs", ctypes.c_long),
        ("uv_faces", ctypes.POINTER(ctypes.c_int)),
    ]


def library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnrobj-{h.hexdigest()[:16]}.so"


def _build(path):
    """Compile into a temporary file beside ``path``, then rename it into
    place: processes building at once each finish with a whole library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The loaded parser (built first if needed), or None when it cannot be
    built or loaded; a failure is not retried in this process."""
    global _lib, _failed
    with _lock:
        if _lib is None and not _failed:
            try:
                path = library_path()
                if not path.exists():
                    _build(path)
                lib = ctypes.CDLL(str(path))
                lib.nr_parse_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(_NrObjMesh)]
                lib.nr_parse_obj.restype = ctypes.c_int
                lib.nr_free_mesh.argtypes = [ctypes.POINTER(_NrObjMesh)]
                lib.nr_free_mesh.restype = None
                _lib = lib
            except (OSError, subprocess.CalledProcessError):
                _failed = True
    return _lib


def parse_obj_native(filename):
    """The geometry of an OBJ file from the C++ parser: (vertices f32 [nv, 3],
    faces i32 [nf, 3] 0-based and fan-triangulated, uvs f32 [nt, 2] or None,
    uv faces i32 [nf, 3] or None), or None when the parser is unavailable.
    Raises FileNotFoundError when the file cannot be read."""
    lib = get_lib()
    if lib is None:
        return None
    mesh = _NrObjMesh()
    rc = lib.nr_parse_obj(os.fsencode(filename), ctypes.byref(mesh))
    if rc != 0:
        raise FileNotFoundError(filename if rc == 1 else f"{filename} (read error)")
    try:
        nv, nf, nt = mesh.num_vertices, mesh.num_faces, mesh.num_uvs
        vertices = (np.ctypeslib.as_array(mesh.vertices, (nv, 3)).copy() if nv
                    else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(mesh.faces, (nf, 3)).copy() if nf
                 else np.zeros((0, 3), np.int32))
        uvs = np.ctypeslib.as_array(mesh.uvs, (nt, 2)).copy() if nt and mesh.uvs else None
        uv_faces = (np.ctypeslib.as_array(mesh.uv_faces, (nf, 3)).copy()
                    if mesh.uv_faces and nf else None)
        return vertices, faces, uvs, uv_faces
    finally:
        lib.nr_free_mesh(ctypes.byref(mesh))
