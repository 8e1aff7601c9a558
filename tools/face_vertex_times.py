#!/usr/bin/env python3
"""Time the face-vertex gather (kernel K5, ``gather_faces3``) and its
transpose (K4, ``scatter_faces_to_vertices``) of a checkout of the port on
one CUDA card, with ``chip_smoke.py``'s own measurements; or K5's kernel
beside other designs of it.

    python3 tools/face_vertex_times.py [--root DIR] [--out FILE]
    python3 tools/face_vertex_times.py --designs [--out FILE]

``--root`` names the checkout whose package is imported (default: the one
that holds this script), so that a change and its parent, unpacked under
``tmp/``, can be timed in turns on one card, each in a process of its own;
that checkout's package must have the ``benchmarks`` subpackage, whose
``steps`` holds the event median, the profiler's reading and the loss.
Measured on the card:

- ``chip_smoke.face_vertex_rows`` at ``chip_smoke.face_vertex_meshes``,
  batch 1 and 8: each wrapper's CUDA-event median in turns with its library
  yardstick, its device time and operations per call, its bound, and
  whether it gives the plain version's bits and repeats them;
- the host µs per call of one K4 and one K5 wrapper call at ``bench``,
  batch 1 (``chip_smoke.per_call_us``);
- the ``bench`` and ``scale`` silhouette steps (``chip_smoke.sil_step``)
  with the faces passed as one int32 tensor on the card, kept between
  steps, and as a numpy array, as the JAX package's ``Renderer`` is
  called: the step's event median, and its device busy time and device
  operations under the profiler.

``--designs`` builds ``tools/gather_faces3_designs.cu`` (K5 with the
block's ids staged in shared memory and the images looped in the block,
the same staging with a block per image, and the port's design with D read
at run time) and times each beside the checkout's K5 at the same meshes,
batch 1 and 8, D = 3: device ms per call under the profiler, in the order
shipped, designs, designs reversed, shipped, each held bit-equal to the
plain version.

The last line of the output is one JSON object, also written to FILE when
given.  Without CUDA the script fails.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESIGNS_SOURCE = os.path.join(HERE, "tools", "gather_faces3_designs.cu")
DESIGNS = ("staged_batch_loop", "staged_per_image", "direct_run_time_d")


def load_chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (a checkout under
    ``--root`` may hold an older one); it imports the package that is first
    on ``sys.path``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_rows(cs, dev, gen):
    """``chip_smoke.face_vertex_rows`` at every mesh and batch 1 and 8."""
    rows = []
    for label, (f, nv) in cs.face_vertex_meshes().items():
        faces = torch.tensor(f, device=dev)
        for bs in (1, 8):
            rows += [dict(config=label, **row) for row in cs.face_vertex_rows(faces, nv, bs, gen)]
    return rows


def wrapper_host_us(cs, dev, gen):
    """Host µs per call of one K4 and one K5 wrapper call at ``bench``,
    batch 1."""
    f, nv = cs.face_vertex_meshes()["bench"]
    faces, rc = torch.tensor(f, device=dev), cs.rc
    g9 = torch.randn((1, 3, 3, len(f)), generator=gen, device=dev)
    table = torch.randn((1, nv, 3), generator=gen, device=dev)
    return {"scatter_faces_to_vertices": cs.per_call_us(
                lambda: rc.scatter_faces_to_vertices(g9, faces, nv)),
            "gather_faces3": cs.per_call_us(lambda: rc.gather_faces3(table, faces))}


def steps(cs, dev):
    """The ``bench`` and ``scale`` silhouette steps with the faces as a kept
    tensor and as a numpy array: {"<config> <form>": {ms, device_busy_ms,
    device_ops, every_record_kept}}."""
    from neural_renderer_v2_pytorch_tpu_torch.benchmarks.steps import (
        bench_loss,
        median_ms,
        profile_device,
    )

    nr, out = cs.nr, {}
    for label, (v, f), size, aa, azimuth, loss in (
            ("bench", cs.torus(40, 32), 256, True, 0.0, bench_loss),
            ("scale", cs.icosphere(6), 512, False, 30.0, cs.pattern_loss)):
        r = nr.Renderer(dev)
        r.image_size, r.anti_aliasing = size, aa
        r.viewpoints = nr.get_points_from_angles(2.732, 30, azimuth)
        vertices = torch.tensor(v[None], device=dev)
        for form, faces in (("tensor", torch.tensor(f, device=dev)), ("numpy", f)):
            step = cs.sil_step(r, vertices, faces, loss)
            ms = median_ms(step, 20, warmup=3)
            prof = profile_device(step)
            out[f"{label} {form}"] = dict(ms=ms, device_busy_ms=prof.busy, device_ops=prof.ops,
                                          every_record_kept=prof.complete)
    return out


def build_designs(cuda_build):
    """Compile DESIGNS_SOURCE into a library under build/ (as the port's
    kernels are built); returns its path."""
    out_dir = os.path.join(HERE, "build", "gather_faces3_designs")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libgather_faces3_designs.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", path,
                    DESIGNS_SOURCE], check=True, capture_output=True, text=True)
    return path


def design_rows(cs, dev, gen):
    """Device ms per call of the checkout's K5 and of each design at every
    mesh, batch 1 and 8, D = 3, each held bit-equal to the plain version."""
    from neural_renderer_v2_pytorch_tpu_torch.benchmarks.steps import profile_device

    rc = cs.rc
    lib = ctypes.CDLL(build_designs(cs.cuda_build))
    entries = {}
    for name in DESIGNS:
        fn = getattr(lib, "nr_gather_faces3_" + name)
        fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
        fn.restype = ctypes.c_int
        entries[name] = fn
    rows = []
    for label, (f, nv) in cs.face_vertex_meshes().items():
        faces, nf = torch.tensor(f, device=dev), len(f)
        for bs in (1, 8):
            table = torch.randn((bs, nv, 3), generator=gen, device=dev)
            want = rc.gather_faces3_plain(table, faces)
            outs = {name: torch.empty_like(want) for name in DESIGNS}
            calls = {"shipped": lambda: rc.gather_faces3(table, faces)}
            for name, fn in entries.items():
                def call(fn=fn, out=outs[name]):
                    err = fn(table.data_ptr(), faces.data_ptr(), out.data_ptr(), bs, nv, 3, nf,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"CUDA error {err}")
                    return out
                calls[name] = call
            exact = {name: bool(torch.equal(call(), want)) for name, call in calls.items()}
            order = list(calls)
            device_ms = {name: [] for name in order}
            for name in order + order[::-1]:
                device_ms[name].append(profile_device(calls[name], 50).busy)
            rows.append(dict(config=label, bs=bs, nf=nf, nv=nv, bit_equal=exact,
                             device_ms={k: float(np.mean(v)) for k, v in device_ms.items()},
                             device_ms_turns=device_ms))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE, help="checkout whose package is timed")
    parser.add_argument("--designs", action="store_true",
                        help="time K5 beside tools/gather_faces3_designs.cu")
    parser.add_argument("--out", help="also write the JSON object here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("face_vertex_times: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = load_chip_smoke()
    if not os.path.abspath(cs.nr.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {cs.nr.__file__}, not the package under {root}")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cs.cuda_build.build()
    cs.cuda_build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = dict(root=os.path.relpath(root, HERE), smi=smi, torch=torch.__version__)
    if args.designs:
        result["designs"] = design_rows(cs, dev, gen)
    else:
        result.update(rows=kernel_rows(cs, dev, gen), wrapper_host_us=wrapper_host_us(cs, dev, gen),
                      steps=steps(cs, dev))
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
