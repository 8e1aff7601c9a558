#!/usr/bin/env python3
"""Drive the PyTorch port's silhouette optimisation step on one CUDA GPU.

    python3 chip_smoke.py

Builds the four hand-written kernels from ``neural_renderer_v2_pytorch_tpu_torch
/csrc``, checks each against its plain PyTorch version on the card, checks the
whole forward+backward against the plain versions and against a golden made
by the JAX package, takes five Adam steps of a vertex fit (the main path, with
every kernel's launch count read around it), repeats the checks on an
81,920-face mesh, and times each kernel, its plain version and the step.

Any failure raises and the script exits non-zero without its last line.  On
success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
There is no CPU path: without CUDA the script fails.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops.gather_resolve import (
    gather_face_vertices,
    resolve_and_gather,
)
from neural_renderer_v2_pytorch_tpu_torch.utils import cuda_build
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import icosphere, torus

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
PKG = "neural_renderer_v2_pytorch_tpu_torch"
TPU_KERNELS = "neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "face_setup": (f"{PKG}/csrc/face_setup.cu", f"{TPU_KERNELS}:180"),
    "resolve_xy": (f"{PKG}/csrc/resolve_xy.cu", f"{TPU_KERNELS}:348"),
    "scatter_pixels_to_faces": (f"{PKG}/csrc/scatter_pixels_to_faces.cu", f"{TPU_KERNELS}:1512"),
    "scatter_faces_to_vertices": (f"{PKG}/csrc/scatter_faces_to_vertices.cu", f"{TPU_KERNELS}:2741"),
}
SCATTER_RTOL = 1e-4   # atomics sum in run-dependent order; the JAX backward's bound


def log(msg):
    print(msg, flush=True)


def check_close(name, got, want, rtol=SCATTER_RTOL):
    err = float((got - want).abs().max())
    bound = rtol * float(want.abs().max())
    if not err <= bound:
        raise AssertionError(f"{name}: max abs err {err} > {bound} ({rtol} of max)")
    return err


def check_equal(name, got, want):
    if not torch.equal(got, want):
        n = int((got != want).sum())
        raise AssertionError(f"{name}: {n} of {got.numel()} elements differ")
    return 0.0


def median_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def profile_device(step, n=10):
    """Profile ``n`` calls: (wall ms/call under the profiler, device busy
    ms/call, device ops/call, [(name, device ms/call)] of the top 6)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    # device-side events only (kernels, copies, fills): a CPU op's entry
    # also carries the device time of what it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    launches = sum(e.count for e in events) / n
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return wall, busy, launches, [(e.key[:60], e.self_device_time_total / n / 1e3) for e in top]


@contextlib.contextmanager
def plain_versions():
    """Run the autograd Functions on the kernels' plain versions."""
    from neural_renderer_v2_pytorch_tpu_torch.ops import gather_resolve as gr

    swap = {name: getattr(rc, name + "_plain") for name in rc.KERNELS}
    saved = {name: getattr(gr, name) for name in swap}
    try:
        for name, fn in swap.items():
            setattr(gr, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(gr, name, fn)


def ndc_scene(vertices, faces, dev, azimuth=0.0):
    """World mesh -> (NDC vertices [1, nv, 3], faces i32) through the port's camera."""
    r = nr.Renderer(dev)
    r.viewpoints = nr.get_points_from_angles(2.732, 30, azimuth)
    v = torch.tensor(vertices[None], device=dev)
    return r.transform_vertices(v), torch.tensor(faces, device=dev)


def kernels_vs_plain(label, ndc, faces, size, gen):
    """Each kernel against its plain version at one scene's shapes.  Returns
    ({name: max_abs_err}, {name: (kernel_call, plain_call)})."""
    dev = ndc.device
    nv, nf = ndc.shape[1], faces.shape[0]
    fvp = gather_face_vertices(ndc, faces).detach()
    errs, calls = {}, {}

    for backside in (True, False):
        ck, cp = rc.face_setup(fvp, backside), rc.face_setup_plain(fvp, backside)
        errs["face_setup"] = check_equal(f"{label} face_setup draw_backside={backside}", ck, cp)
    consts = rc.face_setup(fvp, True)
    calls["face_setup"] = (lambda: rc.face_setup(fvp, True), lambda: rc.face_setup_plain(fvp, True))

    ik, dk, xk = rc.resolve_xy(consts, fvp, size, 0.1, 100.0)
    ip, dp, xp = rc.resolve_xy_plain(consts, fvp, size, 0.1, 100.0)
    diff = ik != ip
    if diff.any():
        gap = float((dk - dp).abs()[diff].max())
        raise AssertionError(
            f"{label} resolve_xy: {int(diff.sum())} pixels differ, depth gap {gap}"
        )
    check_equal(f"{label} resolve_xy depth", dk, dp)
    check_equal(f"{label} resolve_xy coords", xk, xp)
    errs["resolve_xy"] = 0.0
    coverage = float((ik >= 0).float().mean())
    calls["resolve_xy"] = (
        lambda: rc.resolve_xy(consts, fvp, size, 0.1, 100.0),
        lambda: rc.resolve_xy_plain(consts, fvp, size, 0.1, 100.0),
    )

    g6 = torch.randn((1, 6, size, size), generator=gen, device=dev)
    errs["scatter_pixels_to_faces"] = check_close(
        f"{label} scatter_pixels_to_faces",
        rc.scatter_pixels_to_faces(g6, ik, nf), rc.scatter_pixels_to_faces_plain(g6, ik, nf),
    )
    calls["scatter_pixels_to_faces"] = (
        lambda: rc.scatter_pixels_to_faces(g6, ik, nf),
        lambda: rc.scatter_pixels_to_faces_plain(g6, ik, nf),
    )

    g9 = torch.randn((1, 3, 3, nf), generator=gen, device=dev)
    errs["scatter_faces_to_vertices"] = check_close(
        f"{label} scatter_faces_to_vertices",
        rc.scatter_faces_to_vertices(g9, faces, nv), rc.scatter_faces_to_vertices_plain(g9, faces, nv),
    )
    calls["scatter_faces_to_vertices"] = (
        lambda: rc.scatter_faces_to_vertices(g9, faces, nv),
        lambda: rc.scatter_faces_to_vertices_plain(g9, faces, nv),
    )
    torch.cuda.synchronize()
    log(f"[{label}] kernels vs plain: nf={nf} canvas={size}^2 coverage={coverage:.4f} "
        f"max_abs_err={json.dumps(errs)}")
    return errs, calls


def bench_loss(images):
    """The headline bench's IoU-style scalar (bench.py), so the full NMR
    backward runs."""
    return torch.sum(images * images) / (torch.sum(images) + 1.0)


def pattern_loss(images):
    """Squared distance to a fixed diagonal pattern.  Unlike bench_loss it
    gives silhouette edges a gradient without anti-aliasing too (on a binary
    image bench_loss's NMR gradients cancel)."""
    i = torch.arange(images.shape[-1], device=images.device)
    target = ((i[:, None] + i[None, :]) % 7).float() / 6.0
    return torch.sum((images - target) ** 2)


def slice_vs_plain(label, renderer, vertices, faces, loss_fn):
    """Forward+backward through Renderer.render_silhouettes with the kernels
    and with their plain versions: images and index map bit-equal, vertex
    gradients within SCATTER_RTOL."""
    out = []
    for ctx in (contextlib.nullcontext(), plain_versions()):
        with ctx:
            x = vertices.clone().requires_grad_(True)
            images = renderer.render_silhouettes(x, faces)
            loss_fn(images).backward()
            with torch.no_grad():
                fvp = gather_face_vertices(renderer.transform_vertices(vertices), faces)
                size = renderer.image_size * (2 if renderer.anti_aliasing else 1)
                fim = resolve_and_gather(fvp, size, renderer.near, renderer.far,
                                         renderer.draw_backside)[0]
            out.append((images.detach(), fim, x.grad))
    (ik, fk, gk), (ip, fp, gp) = out
    check_equal(f"{label} images", ik, ip)
    check_equal(f"{label} index map", fk, fp)
    err = check_close(f"{label} vertex grads", gk, gp)
    if not torch.isfinite(gk).all() or float(gk.abs().max()) == 0.0:
        raise AssertionError(f"{label}: vertex gradients not finite or all zero")
    log(f"[{label}] slice kernels vs plain: images/index equal, grad max abs err {err} "
        f"(max |g| {float(gp.abs().max())}), coverage {float(ik.mean()):.4f}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    path, seconds, compiler_log = cuda_build.build()
    cuda_build.load()
    log(f"[build] {seconds:.1f} s -> {os.path.relpath(path, ROOT)}")
    for line in compiler_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    # 2. each kernel vs its plain version at the slice's shapes
    tv, tf = torus(40, 32)
    ndc, faces = ndc_scene(tv, tf, dev)
    bench_errs, bench_calls = kernels_vs_plain("bench", ndc, faces, 512, gen)

    # 3. the slice, kernels vs plain versions, through Renderer
    renderer = nr.Renderer(dev)
    renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
    torus_v = torch.tensor(tv[None], device=dev)
    slice_vs_plain("bench", renderer, torus_v, faces, bench_loss)

    # 4. against the JAX package's golden (stored NDC: the camera is bypassed)
    gold = np.load(GOLDEN)
    x = torch.tensor(gold["ndc"], device=dev, requires_grad=True)
    gfaces = torch.tensor(gold["faces"], device=dev)
    images = nr.rasterize_silhouettes(x, gfaces, None, nr.RasterizeHyperparam(image_size=64))
    torch.sum((images - torch.tensor(gold["target"], device=dev)) ** 2).backward()
    with torch.no_grad():
        fim = resolve_and_gather(gather_face_vertices(x, gfaces), 128, 0.1, 100.0, True)[0]
    check_equal("golden image", images.detach().cpu(), torch.tensor(gold["image"]))
    check_equal("golden index map", fim.cpu(), torch.tensor(gold["fim"]))
    err = check_close("golden vertex grads", x.grad.cpu(), torch.tensor(gold["grads"]))
    log(f"[golden] image and index map equal to JAX, grad max abs err {err}")

    # 5. the main path: five Adam steps of a vertex fit, launches counted
    target = renderer.render_silhouettes(torus_v, faces).detach()
    sv, sf = icosphere(3)
    sphere_faces = torch.tensor(sf, device=dev)
    x = torch.tensor(sv[None], device=dev, requires_grad=True)
    opt = torch.optim.Adam([x], lr=0.01)
    losses = []
    torch.cuda.synchronize()
    rc.reset_launches()
    t0 = time.perf_counter()
    for _ in range(5):
        opt.zero_grad()
        loss = torch.sum((renderer.render_silhouettes(x, sphere_faces) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(rc.LAUNCHES)
    log(f"[fit] icosphere(3) -> torus silhouette, 256^2 AA, losses {losses}, "
        f"{fit_s:.3f} s, launches {json.dumps(launches)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fit loss did not fall: {losses}")
    if not all(launches[name] > 0 for name in KERNELS):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # 6. scale: 81,920 faces at 512^2 without anti-aliasing
    iv, ifc = icosphere(6)
    ndc6, faces6 = ndc_scene(iv, ifc, dev, azimuth=30.0)
    _, scale_calls = kernels_vs_plain("scale", ndc6, faces6, 512, gen)
    scale_renderer = nr.Renderer(dev)
    scale_renderer.image_size = 512
    scale_renderer.anti_aliasing = False
    scale_renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 30.0)
    sphere_v = torch.tensor(iv[None], device=dev)
    slice_vs_plain("scale", scale_renderer, sphere_v, faces6, pattern_loss)

    # 7. times
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    # per call: the CUDA-event median (what a caller waits, launch gaps
    # included) and the device time the profiler sees (the work itself)
    times = {}
    for label, calls in (("bench", bench_calls), ("scale", scale_calls)):
        for name, (kernel_call, plain_call) in calls.items():
            slow = label == "scale" and name == "resolve_xy"  # plain: ~5 s a call
            k_ms = median_ms(kernel_call, 50)
            p_ms = median_ms(plain_call, 3 if slow else 10, warmup=1)
            k_dev = profile_device(kernel_call, 20)[1]
            p_dev = None if slow else profile_device(plain_call, 3)[1]
            times[label, name] = (k_ms, p_ms, k_dev, p_dev)
            log(f"[time] {label} {name}: kernel {k_ms:.4f} ms (device {k_dev:.4f} ms), "
                f"plain {p_ms:.4f} ms (device "
                f"{'not measured' if p_dev is None else f'{p_dev:.4f} ms'})  ({smi})")

    def make_step(r, v, f, loss_fn):
        def step():
            xx = v.clone().requires_grad_(True)
            loss_fn(r.render_silhouettes(xx, f)).backward()
        return step

    def step_ms(r, v, f, loss_fn):
        return median_ms(make_step(r, v, f, loss_fn), 20, warmup=3)

    for label, r, v, f, loss_fn in (("bench", renderer, torus_v, faces, bench_loss),
                                    ("scale", scale_renderer, sphere_v, faces6, pattern_loss)):
        ms = step_ms(r, v, f, loss_fn)
        with plain_versions():
            plain = step_ms(r, v, f, loss_fn) if label == "bench" else float("nan")
        mpx = r.image_size ** 2 / ms / 1e3
        log(f"[time] {label} fwd+bwd step ({r.image_size}^2, AA {r.anti_aliasing}, "
            f"nf {f.shape[0]}): {ms:.4f} ms = {mpx:.3f} Mpx/s; plain versions "
            f"{plain:.4f} ms  ({smi})")
        wall, busy, n_launch, top = profile_device(make_step(r, v, f, loss_fn))
        if busy == 0.0:
            log(f"[profile] {label}: the profiler saw no device time (not measured)")
        else:
            log(f"[profile] {label} step under torch.profiler: wall {wall:.4f} ms, device "
                f"busy {busy:.4f} ms ({100 * busy / wall:.1f}%), {n_launch:.0f} device "
                f"ops/step; top " + ", ".join(f"{k} {t:.4f} ms" for k, t in top))

    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": bench_errs[name],
         "ms": times["bench", name][0], "plain_ms": times["bench", name][1],
         "device_ms": times["bench", name][2], "plain_device_ms": times["bench", name][3]}
        for name, (src, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
