#!/usr/bin/env python3
"""Drive the PyTorch port's optimisation steps on one CUDA GPU: silhouettes,
and textured, lit and depth rendering.

    python3 chip_smoke.py

Builds the seven hand-written kernels from ``neural_renderer_v2_pytorch_tpu_torch
/csrc`` (one nvcc per source, in parallel) and then, for each of the two
paths:

- silhouettes: checks each kernel against its plain PyTorch version on the
  card, the whole forward+backward against the plain versions and against a
  golden made by the JAX package, takes five Adam steps of a vertex fit
  (launch counts read around it), and repeats the checks on an 81,920-face
  mesh;
- textured: checks K5, K2L, K3 and K6 against their plain versions at the
  ``atlas``, ``lit`` and ``textured-scale`` configurations, the ``atlas``
  and ``lit`` steps through ``Renderer.render`` (and depth and
  ``rasterize_all`` at ``atlas``) against the plain versions, the RGB
  golden, and takes five Adam steps of an atlas + vertex fit (launch counts
  read around it);

then times each kernel, its plain version and each step, with CUDA events
and the profiler's device time.

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
from neural_renderer_v2_pytorch_tpu_torch.ops import shading
from neural_renderer_v2_pytorch_tpu_torch.ops.gather_resolve import (
    gather_face_vertices,
    resolve_and_gather,
)
from neural_renderer_v2_pytorch_tpu_torch.ops.rasterize import face_attributes
from neural_renderer_v2_pytorch_tpu_torch.ops.resolve import weight_planes_from_gathered
from neural_renderer_v2_pytorch_tpu_torch.utils import cuda_build
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import (
    atlas_scene,
    icosphere,
    lit_light_arrays,
    texel_scene,
    torus,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
RGB_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_rgb_golden.npz")
PKG = "neural_renderer_v2_pytorch_tpu_torch"
TPU_KERNELS = "neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py"
# name -> (source, the TPU kernel it replaces, the configuration its times
# in the kernels line come from)
KERNELS = {
    "face_setup": (f"{PKG}/csrc/face_setup.cu", f"{TPU_KERNELS}:180", "bench"),
    "resolve_xy": (f"{PKG}/csrc/resolve.cu", f"{TPU_KERNELS}:348", "bench"),
    "resolve_latch": (f"{PKG}/csrc/resolve.cu", f"{TPU_KERNELS}:348", "atlas"),
    "scatter_pixels_to_faces": (f"{PKG}/csrc/scatter_pixels_to_faces.cu", f"{TPU_KERNELS}:1512", "bench"),
    "scatter_faces_to_vertices": (f"{PKG}/csrc/scatter_faces_to_vertices.cu", f"{TPU_KERNELS}:2741", "bench"),
    "gather_faces3": (f"{PKG}/csrc/gather_faces3.cu", f"{TPU_KERNELS}:2605", "atlas"),
    "scatter_rows": (f"{PKG}/csrc/scatter_rows.cu", f"{TPU_KERNELS}:2090", "atlas"),
}
SILHOUETTE_KERNELS = ("face_setup", "resolve_xy", "scatter_pixels_to_faces",
                      "scatter_faces_to_vertices", "gather_faces3")
TEXTURED_KERNELS = ("face_setup", "resolve_latch", "scatter_pixels_to_faces",
                    "scatter_faces_to_vertices", "gather_faces3", "scatter_rows")
SCATTER_RTOL = 1e-4   # atomics sum in run-dependent order; the JAX backward's bound
GOLDEN_IMAGE_ATOL = 1e-5   # CUDA's pow and the card's sums against XLA:CPU
# name -> (scene, texture_size, lit, image_size, anti_aliasing): rows of the
# JAX package's perf matrix (README.md:119-136, benchmarks/scaling.py:154-247)
TEXTURED = {
    "atlas": (lambda: atlas_scene(40, 32), None, False, 256, True),
    "lit": (lambda: texel_scene(40, 32, 2), 2, True, 256, True),
    "textured-scale": (lambda: texel_scene(320, 248, 2), 2, False, 512, False),
}


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


def ndc_scene(vertices, faces, dev, azimuth=0.0):
    """World mesh -> (NDC vertices [1, nv, 3], faces i32) through the port's camera."""
    r = nr.Renderer(dev)
    r.viewpoints = nr.get_points_from_angles(2.732, 30, azimuth)
    v = torch.tensor(vertices[None], device=dev)
    return r.transform_vertices(v), torch.tensor(faces, device=dev)


def kernels_vs_plain(label, ndc, faces, size, gen):
    """Each silhouette kernel against its plain version at one scene's
    shapes.  Returns ({name: max_abs_err}, {name: (kernel_call, plain_call)})."""
    dev = ndc.device
    nv, nf = ndc.shape[1], faces.shape[0]
    table = ndc.detach().contiguous()
    fvp = rc.gather_faces3(table, faces)
    errs, calls = {}, {}
    errs["gather_faces3"] = check_equal(f"{label} gather_faces3", fvp,
                                        rc.gather_faces3_plain(table, faces))
    calls["gather_faces3"] = (lambda: rc.gather_faces3(table, faces),
                              lambda: rc.gather_faces3_plain(table, faces))

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


def index_map(renderer, vertices, faces, latch_z):
    with torch.no_grad():
        fvp = gather_face_vertices(renderer.transform_vertices(vertices), faces)
        size = renderer.image_size * (2 if renderer.anti_aliasing else 1)
        return resolve_and_gather(fvp, size, renderer.near, renderer.far,
                                  renderer.draw_backside, None, latch_z)[0]


def steps_vs_plain(label, step, fim):
    """``step()`` -> (images, {name: gradient}) with the kernels and with
    their plain versions: images and index map (``fim()``) bit-equal,
    gradients within SCATTER_RTOL of their largest magnitude."""
    out = []
    for ctx in (contextlib.nullcontext(), rc.plain_versions()):
        with ctx:
            images, grads = step()
            out.append((images, grads, fim()))
    (ik, gk, fk), (ip, gp, fp) = out
    check_equal(f"{label} images", ik, ip)
    check_equal(f"{label} index map", fk, fp)
    errs = {}
    for name in gp:
        if not torch.isfinite(gk[name]).all() or float(gk[name].abs().max()) == 0.0:
            raise AssertionError(f"{label}: {name} gradients not finite or all zero")
        errs[name] = check_close(f"{label} {name} grads", gk[name], gp[name])
    log(f"[{label}] step kernels vs plain: images/index equal, grad max abs err "
        f"{json.dumps(errs)} (max |g| "
        f"{json.dumps({k: float(v.abs().max()) for k, v in gp.items()})}), "
        f"coverage {float((fk >= 0).float().mean()):.4f}")


def slice_vs_plain(label, renderer, vertices, faces, loss_fn):
    """Forward+backward through Renderer.render_silhouettes with the kernels
    and with their plain versions."""
    def step():
        x = vertices.clone().requires_grad_(True)
        images = renderer.render_silhouettes(x, faces)
        loss_fn(images).backward()
        return images.detach(), {"vertices": x.grad}

    steps_vs_plain(label, step, lambda: index_map(renderer, vertices, faces, False))


class Textured:
    """One textured configuration on the card (see TEXTURED)."""

    def __init__(self, name, dev):
        make_scene, texture_size, lit, image_size, anti_aliasing = TEXTURED[name]
        v, f, vt, ft, tex = make_scene()
        self.name = name
        self.renderer = r = nr.Renderer(dev)
        r.image_size, r.anti_aliasing, r.texture_size = image_size, anti_aliasing, texture_size
        r.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
        self.vertices = torch.tensor(v[None], device=dev)
        self.faces = torch.tensor(f, device=dev)
        self.vt = torch.tensor(vt, device=dev)
        self.ft = torch.tensor(ft, device=dev)
        self.textures = torch.tensor(tex, device=dev)
        self.light_arrays = lit_light_arrays() if lit else None
        self.size = image_size * (2 if anti_aliasing else 1)

    def lights(self):
        """Fresh lights whose colours take gradients, or None."""
        if self.light_arrays is None:
            return None
        cls = {"ambient": nr.AmbientLight, "directional": nr.DirectionalLight,
               "specular": nr.SpecularLight}
        out = []
        for kind, arrays in self.light_arrays:
            fields = {k: torch.tensor(a, device=self.vertices.device) for k, a in arrays.items()}
            fields["color"].requires_grad_(True)
            out.append(cls[kind](**fields))
        return tuple(out)

    def params(self, textures=None, lights=None):
        return nr.RasterizeParam(
            vertices_textures=self.vt, faces_textures=self.ft,
            textures=self.textures if textures is None else textures,
            texture_size=self.renderer.texture_size, lights=lights,
        )

    def step(self, entry="rgba"):
        """Forward + backward of sum(image^2), the perf matrix's loss:
        (images, {name: gradient}) into the vertices, the atlas (``atlas``)
        and the light colours (``lit``)."""
        x = self.vertices.clone().requires_grad_(True)
        tex = self.textures.clone().requires_grad_(self.name == "atlas")
        lights = self.lights()
        if entry == "rgba":
            images = self.renderer.render(x, self.faces, self.vt, self.ft, tex, lights=lights)
        elif entry == "depth":
            images = self.renderer.render_depth(x, self.faces)
        else:
            r = self.renderer
            hp = nr.RasterizeHyperparam(image_size=r.image_size, anti_aliasing=r.anti_aliasing)
            images = nr.rasterize_all(r.transform_vertices(x), self.faces,
                                      self.params(tex, lights), hp)
        torch.sum(images * images).backward()
        grads = {"vertices": x.grad}
        if tex.grad is not None:
            grads["textures"] = tex.grad
        for i, light in enumerate(lights or ()):
            grads[f"light{i}_color"] = light.color.grad
        return images.detach(), grads

    def fim(self):
        return index_map(self.renderer, self.vertices, self.faces, True)

    def latch_inputs(self):
        """(table, fvp, consts, face attributes) as the RGB path builds them."""
        with torch.no_grad():
            ndc = self.renderer.transform_vertices(self.vertices).contiguous()
            fvp = gather_face_vertices(ndc, self.faces)
            attrs = face_attributes(ndc, self.faces, fvp, self.params(lights=self.lights()))
        return ndc, fvp, rc.face_setup(fvp, True), attrs.contiguous()


def textured_kernels_vs_plain(cfg, gen):
    """K5, K2L, K3 (D = 9 + A) and, for ``atlas``, K6 against their plain
    versions at a configuration's shapes.  Returns ({name: max_abs_err},
    {name: (kernel_call, plain_call)}, ms of the one plain resolve call)."""
    dev = cfg.vertices.device
    ndc, fvp, consts, attrs = cfg.latch_inputs()
    S, nf, A = cfg.size, fvp.shape[-1], attrs.shape[-1]
    errs, calls = {}, {}
    errs["gather_faces3"] = check_equal(f"{cfg.name} gather_faces3", fvp,
                                        rc.gather_faces3_plain(ndc, cfg.faces))
    calls["gather_faces3"] = (lambda: rc.gather_faces3(ndc, cfg.faces),
                              lambda: rc.gather_faces3_plain(ndc, cfg.faces))

    got = rc.resolve_latch(consts, fvp, attrs, S, 0.1, 100.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rc.resolve_latch_plain(consts, fvp, attrs, S, 0.1, 100.0)
    torch.cuda.synchronize()
    plain_resolve_ms = (time.perf_counter() - t0) * 1e3
    for part, g, w in zip(("index", "depth", "coords", "attrs"), got, want):
        check_equal(f"{cfg.name} resolve_latch {part}", g, w)
    errs["resolve_latch"] = 0.0
    index, _, coords, attr_planes = got
    calls["resolve_latch"] = (lambda: rc.resolve_latch(consts, fvp, attrs, S, 0.1, 100.0),
                              lambda: rc.resolve_latch_plain(consts, fvp, attrs, S, 0.1, 100.0))

    g = torch.randn((1, 9 + A, S, S), generator=gen, device=dev)
    errs["scatter_pixels_to_faces"] = check_close(
        f"{cfg.name} scatter_pixels_to_faces D={9 + A}",
        rc.scatter_pixels_to_faces(g, index, nf), rc.scatter_pixels_to_faces_plain(g, index, nf),
    )
    calls["scatter_pixels_to_faces"] = (lambda: rc.scatter_pixels_to_faces(g, index, nf),
                                        lambda: rc.scatter_pixels_to_faces_plain(g, index, nf))

    if cfg.renderer.texture_size is None:
        # the quad anchors the atlas sampler scatters its gradient to
        # (shading._AtlasTaps)
        th, tw = cfg.textures.shape[2:]
        w = weight_planes_from_gathered(coords, index, S)
        x, y = shading._uv_coords(
            (coords[:, 2], coords[:, 5], coords[:, 8]),
            (attr_planes[:, 0], attr_planes[:, 2], attr_planes[:, 4]),
            (attr_planes[:, 1], attr_planes[:, 3], attr_planes[:, 5]),
            (w[:, 0], w[:, 1], w[:, 2]), index >= 0, 1e-5,
        )
        x0, y0, _ = shading._bilinear_taps(x, y)
        T = th * tw
        anchors = torch.where(index >= 0, torch.clamp(y0 * tw + x0, 0, T - tw - 2), -1)
        anchors = anchors.reshape(1, S * S).contiguous()       # -1: background
        g12 = torch.randn((1, 12, S * S), generator=gen, device=dev)
        errs["scatter_rows"] = check_close(
            f"{cfg.name} scatter_rows",
            rc.scatter_rows(g12, anchors, T), rc.scatter_rows_plain(g12, anchors, T),
        )
        calls["scatter_rows"] = (lambda: rc.scatter_rows(g12, anchors, T),
                                 lambda: rc.scatter_rows_plain(g12, anchors, T))
    torch.cuda.synchronize()
    log(f"[{cfg.name}] kernels vs plain: nf={nf} A={A} canvas={S}^2 coverage="
        f"{float((index >= 0).float().mean()):.4f} max_abs_err={json.dumps(errs)}; "
        f"one plain resolve call {plain_resolve_ms:.1f} ms")
    return errs, calls, plain_resolve_ms


def rgb_golden(dev):
    """The JAX package's RGB golden (stored NDC: the camera is bypassed):
    index map equal, images within GOLDEN_IMAGE_ATOL, gradients within
    SCATTER_RTOL of their largest magnitude."""
    gold = np.load(RGB_GOLDEN)
    faces = torch.tensor(gold["faces"], device=dev)
    hp = nr.RasterizeHyperparam(image_size=64)
    errs = {}
    for name, (_, f, vt, ft, tex), lit in (("atlas", atlas_scene(40, 32, 40, 64), False),
                                         ("lit", texel_scene(40, 32, 2), True)):
        leaves = {"vertices": gold["ndc"], "vertices_textures": vt, "textures": tex}
        arrays = [a for _, a in lit_light_arrays()] if lit else []
        for i, a in enumerate(arrays):
            leaves.update({f"light{i}_{k}": v for k, v in a.items()})
        t = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in leaves.items()}
        lights = None
        if lit:
            lights = (
                nr.DirectionalLight(t["light0_color"], t["light0_direction"]),
                nr.AmbientLight(t["light1_color"]),
                nr.SpecularLight(t["light2_color"]),
            )
        params = nr.RasterizeParam(
            vertices_textures=t["vertices_textures"], faces_textures=torch.tensor(ft, device=dev),
            textures=t["textures"], texture_size=2 if lit else None, lights=lights,
        )
        images = nr.rasterize_rgba(t["vertices"], faces, params, hp)
        torch.sum(images * images).backward()
        errs[f"{name} image"] = check_close(
            f"golden {name} image", images.detach().cpu(),
            torch.tensor(gold[f"{name}_image"]), rtol=GOLDEN_IMAGE_ATOL,
        )
        for key in gold.files:
            if key.startswith(f"{name}_grad_"):
                errs[key] = check_close(f"golden {key}", t[key[len(name) + 6:]].grad.cpu(),
                                        torch.tensor(gold[key]))
    with torch.no_grad():
        x = torch.tensor(gold["ndc"], device=dev)
        fim = resolve_and_gather(gather_face_vertices(x, faces), 128, 0.1, 100.0, True,
                                 None, True)[0]
    check_equal("golden RGB index map", fim.cpu(), torch.tensor(gold["fim"]))
    log(f"[golden rgb] index map equal to JAX, max abs errs {json.dumps(errs)}")


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

    # 2. each silhouette kernel vs its plain version at the slice's shapes
    tv, tf = torus(40, 32)
    ndc, faces = ndc_scene(tv, tf, dev)
    all_errs = {}
    bench_errs, bench_calls = kernels_vs_plain("bench", ndc, faces, 512, gen)
    all_errs.update(bench_errs)

    # 3. the silhouette slice, kernels vs plain versions, through Renderer
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

    # 5. the silhouette main path: five Adam steps of a vertex fit
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
    sil_launches = dict(rc.LAUNCHES)
    log(f"[fit] icosphere(3) -> torus silhouette, 256^2 AA, losses {losses}, "
        f"{fit_s:.3f} s, launches {json.dumps(sil_launches)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fit loss did not fall: {losses}")
    if not all(sil_launches[name] > 0 for name in SILHOUETTE_KERNELS):
        raise AssertionError(f"a kernel of the silhouette path never launched: {sil_launches}")

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

    # 7. the textured kernels vs their plain versions at the three
    # configurations (one plain resolve call each)
    cfgs = {name: Textured(name, dev) for name in TEXTURED}
    tex_calls, plain_resolve_ms = {}, {}
    for name, cfg in cfgs.items():
        errs, tex_calls[name], plain_resolve_ms[name] = textured_kernels_vs_plain(cfg, gen)
        for k, e in errs.items():
            all_errs[k] = max(all_errs.get(k, 0.0), e)

    # 8. the textured steps, kernels vs plain versions
    steps_vs_plain("atlas", cfgs["atlas"].step, cfgs["atlas"].fim)
    steps_vs_plain("lit", cfgs["lit"].step, cfgs["lit"].fim)
    steps_vs_plain("atlas depth", lambda: cfgs["atlas"].step("depth"), cfgs["atlas"].fim)
    steps_vs_plain("atlas all", lambda: cfgs["atlas"].step("all"), cfgs["atlas"].fim)

    # 9. against the JAX package's RGB golden
    rgb_golden(dev)

    # 10. the textured main path: five Adam steps of an atlas + vertex fit
    atlas = cfgs["atlas"]
    with torch.no_grad():
        target = atlas.renderer.render(atlas.vertices, atlas.faces, atlas.vt, atlas.ft,
                                       atlas.textures)
    x = (1.05 * atlas.vertices).requires_grad_(True)
    tex = torch.full_like(atlas.textures, 0.5).requires_grad_(True)
    opt = torch.optim.Adam([{"params": [x], "lr": 0.005}, {"params": [tex], "lr": 0.05}])
    losses = []
    torch.cuda.synchronize()
    rc.reset_launches()
    t0 = time.perf_counter()
    for _ in range(5):
        opt.zero_grad()
        images = atlas.renderer.render(x, atlas.faces, atlas.vt, atlas.ft, tex)
        loss = torch.sum((images - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    tex_launches = dict(rc.LAUNCHES)
    log(f"[fit] atlas + vertices of torus(40, 32), 1190x1920 atlas, 256^2 AA, losses "
        f"{losses}, {fit_s:.3f} s, launches {json.dumps(tex_launches)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"textured fit loss did not fall: {losses}")
    if not all(tex_launches[name] > 0 for name in TEXTURED_KERNELS):
        raise AssertionError(f"a kernel of the textured path never launched: {tex_launches}")

    # 11. times
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    # per call: the CUDA-event median (what a caller waits, launch gaps
    # included) and the device time the profiler sees (the work itself)
    times = {}
    all_calls = [("bench", bench_calls), ("scale", scale_calls)] + list(tex_calls.items())
    for label, calls in all_calls:
        for name, (kernel_call, plain_call) in calls.items():
            # plain resolves at tens of thousands of faces take seconds a call
            slow = label in ("scale", "textured-scale") and name.startswith("resolve")
            k_ms = median_ms(kernel_call, 50)
            if slow and name == "resolve_latch":
                p_ms = plain_resolve_ms[label]        # the one call of phase 7
            else:
                p_ms = median_ms(plain_call, 3 if slow else 10, warmup=1)
            k_dev = profile_device(kernel_call, 20)[1]
            # 20 calls where cheap: over 3 calls of a few-microsecond op the
            # profiler has returned no device events
            p_dev = None if slow else profile_device(
                plain_call, 3 if name.startswith("resolve") else 20)[1]
            times[label, name] = (k_ms, p_ms, k_dev, p_dev)
            log(f"[time] {label} {name}: kernel {k_ms:.4f} ms (device {k_dev:.4f} ms), "
                f"plain {p_ms:.4f} ms (device "
                f"{'not measured' if p_dev is None else f'{p_dev:.4f} ms'})  ({smi})")

    def sil_step(r, v, f, loss_fn):
        def step():
            xx = v.clone().requires_grad_(True)
            loss_fn(r.render_silhouettes(xx, f)).backward()
        return step

    steps = [
        ("bench", renderer, sil_step(renderer, torus_v, faces, bench_loss), True),
        ("scale", scale_renderer, sil_step(scale_renderer, sphere_v, faces6, pattern_loss), False),
    ] + [(name, cfg.renderer, cfg.step, name != "textured-scale") for name, cfg in cfgs.items()]
    for label, r, step, with_plain in steps:
        ms = median_ms(step, 20, warmup=3)
        plain = float("nan")
        if with_plain:
            with rc.plain_versions():
                plain = median_ms(step, 5, warmup=1)
        mpx = r.image_size ** 2 / ms / 1e3
        log(f"[time] {label} fwd+bwd step ({r.image_size}^2, AA {r.anti_aliasing}): "
            f"{ms:.4f} ms = {mpx:.3f} Mpx/s; plain versions {plain:.4f} ms  ({smi})")
        wall, busy, n_launch, top = profile_device(step)
        if busy == 0.0:
            log(f"[profile] {label}: the profiler saw no device time (not measured)")
        else:
            log(f"[profile] {label} step under torch.profiler: wall {wall:.4f} ms, device "
                f"busy {busy:.4f} ms ({100 * busy / wall:.1f}%), {n_launch:.0f} device "
                f"ops/step; top " + ", ".join(f"{k} {t:.4f} ms" for k, t in top))

    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sil_launches[name] + tex_launches[name],
         "max_abs_err": all_errs[name], "config": at,
         "ms": times[at, name][0], "plain_ms": times[at, name][1],
         "device_ms": times[at, name][2], "plain_device_ms": times[at, name][3]}
        for name, (src, replaces, at) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
