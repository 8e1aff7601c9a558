"""Forward and forward+backward times of silhouette and textured rendering
over a sweep of azimuths (the port's counterpart of the JAX package's
``benchmarks/measure_time.py``).

    python -m neural_renderer_v2_pytorch_tpu_torch.benchmarks.measure_time [--iters 24]

Four functions at 256^2 with anti-aliasing, batch 1, each called once per
azimuth (``--iters`` of them over 360 degrees, the camera at distance
2.732 and elevation 30): the silhouette forward, the silhouette forward +
backward of ``sum(images^2)`` into the vertices, the textured forward (a
``create_textures`` atlas of texture size 2, seeded random texels,
``texture_size`` set so the per-face patch sampler runs) and its forward +
backward into the vertices and the atlas.  Each time is the median of the
calls' CUDA-event times in the graphed-core form (each render replays its
CUDA graph, after warm-up calls that capture it).  The mesh is ``bench``'s
(the torus OBJ).  The output ends with the throughput line and one JSON
object.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.camera import look_at, perspective
from ..ops.rasterize import (
    RasterizeHyperparam,
    RasterizeParam,
    rasterize_rgb,
    rasterize_silhouettes,
)
from ..utils.helpers import create_textures
from . import steps

FUNCTIONS = ("silhouette forward", "silhouette forward+backward", "textured forward",
             "textured forward+backward")
WARMUP = 3
IMAGE_SIZE, TEXTURE_SIZE = 256, 2


class Scene:
    """The inputs on ``device``: vertices [batch, nv, 3], faces, a
    ``create_textures`` atlas of seeded random texels [batch, 3, th, tw]
    with its texel coordinates, the hyperparameters, and an eye [3] per
    azimuth."""

    def __init__(self, vertices, faces, image_size=256, texture_size=2, batch=1, iters=24,
                 device="cuda", seed=0):
        vt, ft, tex = (t.numpy() for t in create_textures(len(faces), texture_size, device="cpu"))
        tex = np.random.RandomState(seed).rand(*tex.shape).astype(np.float32)

        def batched(a):
            return torch.tensor(np.tile(np.asarray(a, np.float32)[None],
                                        (batch,) + (1,) * np.ndim(a)), device=device)

        self.vertices, self.vt, self.textures = batched(vertices), batched(vt), batched(tex)
        self.faces = torch.tensor(np.asarray(faces, np.int32), device=device)
        self.ft = torch.tensor(ft, device=device)
        self.texture_size = texture_size
        self.hp = RasterizeHyperparam(image_size=image_size)
        self.eyes = [torch.tensor(e, device=device)
                     for e in steps.eyes(np.linspace(0, 360, iters, endpoint=False))]

    def camera(self, x, eye):
        return perspective(look_at(x, eye), angle=steps.VIEWING_ANGLE)

    def params(self, textures):
        return RasterizeParam(vertices_textures=self.vt, faces_textures=self.ft,
                              textures=textures, texture_size=self.texture_size)


def silhouette_forward(scene, eye):
    return rasterize_silhouettes(scene.camera(scene.vertices, eye), scene.faces, None, scene.hp)


def silhouette_backward(scene, eye):
    """The gradient of ``sum(images^2)`` into the vertices."""
    x = scene.vertices.clone().requires_grad_(True)
    images = rasterize_silhouettes(scene.camera(x, eye), scene.faces, None, scene.hp)
    torch.sum(images ** 2).backward()
    return x.grad


def textured_forward(scene, eye):
    return rasterize_rgb(scene.camera(scene.vertices, eye), scene.faces,
                         scene.params(scene.textures), scene.hp)


def textured_backward(scene, eye):
    """The gradients of ``sum(images^2)`` into the vertices and the atlas."""
    x = scene.vertices.clone().requires_grad_(True)
    t = scene.textures.clone().requires_grad_(True)
    images = rasterize_rgb(scene.camera(x, eye), scene.faces, scene.params(t), scene.hp)
    torch.sum(images ** 2).backward()
    return x.grad, t.grad


def per_call_ms(fn, scene):
    """The median CUDA-event ms of one call of ``fn`` at each azimuth, after
    WARMUP calls at the first (the render's capture)."""
    for _ in range(WARMUP):
        fn(scene, scene.eyes[0])
    torch.cuda.synchronize()
    events = []
    for eye in scene.eyes:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(scene, eye)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def run(device, iters=24):
    name, power_limit = steps.card()
    v, f = steps.bench_mesh()
    scene = Scene(v, f, IMAGE_SIZE, TEXTURE_SIZE, 1, iters, device)
    fns = (silhouette_forward, silhouette_backward, textured_forward, textured_backward)
    ms = {label: per_call_ms(fn, scene) for label, fn in zip(FUNCTIONS, fns)}
    for label, t in ms.items():
        print("%-28s %10.6f ms / call  (%s, %s)" % (label, t, name, power_limit), flush=True)
    px = IMAGE_SIZE ** 2
    mpx = {"silhouette": px / ms["silhouette forward+backward"] / 1e3,
           "textured": px / ms["textured forward+backward"] / 1e3}
    print("throughput: %.2f Mpx/s silhouette fwd+bwd, %.2f Mpx/s textured fwd+bwd"
          % (mpx["silhouette"], mpx["textured"]), flush=True)
    return dict(module="measure_time", device=name, power_limit=power_limit,
                faces=int(f.shape[0]), image_size=IMAGE_SIZE, texture_size=TEXTURE_SIZE,
                azimuths=iters, ms=ms, mpx_per_s=mpx)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=24, help="azimuths (reference: 24)")
    args = parser.parse_args(argv)
    if steps.needs_card("measure_time"):
        return steps.NO_CARD
    steps.build_kernels()
    steps.emit(run(torch.device("cuda:0"), args.iters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
