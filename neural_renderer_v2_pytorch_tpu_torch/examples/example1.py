"""Example 1: drawing a mesh from a sweep of viewpoints (reference
examples_pytorch/example1.py; JAX package examples/example1.py).

All views of one batch render in one call: the camera is a [bs, 3] tensor
swept through ``look_at`` and ``perspective``.  Writes a GIF.
"""

import argparse
import os
import types

import numpy as np
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr

CAMERA_DISTANCE = 2.732
ELEVATION = 30


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-i", "--input_file", type=str, default="./data/torus.obj")
    parser.add_argument("-o", "--output_file", type=str, default="./data/example1.gif")
    parser.add_argument("-b", "--batch", type=int, default=30, help="cameras per call")
    parser.add_argument("-s", "--image_size", type=int, default=256)
    parser.add_argument("--azimuth_step", type=int, default=4)
    # a render-only sweep has no optimisation steps: caps the number of
    # views when given
    parser.add_argument("-n", "--num_views", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def setup(args):
    """The sweep's renderer, mesh and azimuths, as a namespace."""
    device = torch.device(args.device)
    vertices, faces = nr.load_obj(args.input_file, device=device)
    renderer = nr.Renderer(device)
    renderer.image_size = args.image_size
    azimuths = np.arange(0, 360, args.azimuth_step, dtype="float32")
    if args.num_views is not None:
        azimuths = azimuths[: args.num_views]
    return types.SimpleNamespace(renderer=renderer, vertices=vertices, faces=faces,
                                 azimuths=azimuths)


def render_batch(sweep, azimuths):
    """The silhouettes [bs, S, S] from ``azimuths`` [bs], in one call; the
    renderer keeps these viewpoints."""
    device = sweep.vertices.device
    bs = len(azimuths)
    sweep.renderer.viewpoints = nr.get_points_from_angles(
        torch.full((bs,), CAMERA_DISTANCE, device=device),
        torch.full((bs,), float(ELEVATION), device=device),
        torch.tensor(azimuths, device=device),
    )
    return sweep.renderer.render_silhouettes(sweep.vertices[None].expand(bs, -1, -1),
                                             sweep.faces)


def run(argv=None):
    """Render the sweep and write the GIF; returns the number of views."""
    args = parse_arguments(argv)
    working_dir = os.path.dirname(args.output_file) or "."
    os.makedirs(working_dir, exist_ok=True)
    if not args.input_file.endswith(".obj"):
        raise RuntimeError("Only .obj files are currently supported as input.")

    sweep = setup(args)
    num = 0
    with torch.no_grad():
        for start in range(0, len(sweep.azimuths), args.batch):
            images = render_batch(sweep, sweep.azimuths[start : start + args.batch])
            for image in images.cpu().numpy():
                lo, hi = image.min(), image.max()
                frame = (image - lo) / max(hi - lo, 1e-8)
                nr.imsave("%s/_tmp_%04d.png" % (working_dir, num), frame)
                num += 1

    nr.make_gif(working_dir, args.output_file)
    print("wrote", args.output_file)
    return num


if __name__ == "__main__":
    run()
