"""Example 2: optimising mesh vertices to match a reference silhouette
(reference examples_pytorch/example2.py; JAX package examples/example2.py).

``torch.optim.Adam(1e-3)`` on the vertices, as the reference; writes the
optimisation and a turntable of the result as GIFs.
"""

import argparse
import os
import types

import numpy as np
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import EXAMPLE2_VIEW

# the view write_example_data renders example2_ref.png from
CAMERA_DISTANCE, ELEVATION, AZIMUTH = EXAMPLE2_VIEW


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-io", "--input_obj_file", type=str, default="./data/torus.obj")
    parser.add_argument("-ir", "--input_ref_file", type=str, default="./data/example2_ref.png")
    parser.add_argument("-oo", "--output_opt_file", type=str, default="./data/example2_opt.gif")
    parser.add_argument("-or", "--output_res_file", type=str, default="./data/example2_res.gif")
    parser.add_argument("-n", "--num_steps", type=int, default=300)
    parser.add_argument("-s", "--image_size", type=int, default=256,
                        help="render size; the reference image is subsampled to match")
    parser.add_argument("--sweep_step", type=int, default=4,
                        help="azimuth stride of the final turntable")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def setup(args):
    """The fit's renderer, mesh and target: (renderer, vertices, faces,
    image_ref) as a namespace; ``param`` is what the fit optimises."""
    device = torch.device(args.device)
    vertices, faces = nr.load_obj(args.input_obj_file, device=device)
    image_ref = nr.imread(args.input_ref_file).mean(-1)
    k = image_ref.shape[0] // args.image_size
    if k * args.image_size != image_ref.shape[0]:
        raise ValueError(f"image size {args.image_size} does not divide the reference's "
                         f"{image_ref.shape[0]}")
    renderer = nr.Renderer(device)
    renderer.image_size = args.image_size
    renderer.viewpoints = nr.get_points_from_angles(CAMERA_DISTANCE, ELEVATION, AZIMUTH)
    return types.SimpleNamespace(
        renderer=renderer, vertices=vertices, faces=faces, param=vertices,
        image_ref=torch.tensor(np.ascontiguousarray(image_ref[::k, ::k]), device=device))


def forward(fit, vertices):
    """(silhouette [1, S, S], loss) of ``vertices`` [nv, 3]."""
    images = fit.renderer.render_silhouettes(vertices[None], fit.faces)
    return images, torch.sum((images[0] - fit.image_ref) ** 2)


def _save_frame(path, image):
    image = image.detach().cpu().numpy()
    lo, hi = image.min(), image.max()
    nr.imsave(path, (image - lo) / max(hi - lo, 1e-8))


def run(argv=None):
    """The fit, its GIFs; returns the loss of every step."""
    args = parse_arguments(argv)
    working_dir = os.path.dirname(args.output_res_file) or "."
    os.makedirs(working_dir, exist_ok=True)
    fit = setup(args)

    vertices = fit.vertices.clone().requires_grad_(True)
    opt = torch.optim.Adam([vertices], lr=1e-3)   # the reference's (example2.py:69)
    losses = []
    for i in range(args.num_steps):
        opt.zero_grad()
        _, loss = forward(fit, vertices)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if i % 10 == 0 or i == args.num_steps - 1:
            print("step %d: loss %.3f" % (i, losses[-1]))
        with torch.no_grad():
            _save_frame("%s/_tmp_%04d.png" % (working_dir, i), forward(fit, vertices)[0][0])
    nr.make_gif(working_dir, args.output_opt_file)

    # the optimised mesh from a sweep of azimuths
    with torch.no_grad():
        for num, azimuth in enumerate(range(0, 360, args.sweep_step)):
            fit.renderer.viewpoints = nr.get_points_from_angles(CAMERA_DISTANCE, ELEVATION,
                                                                azimuth)
            _save_frame("%s/_tmp_%04d.png" % (working_dir, num), forward(fit, vertices)[0][0])
    nr.make_gif(working_dir, args.output_res_file)
    print("wrote", args.output_opt_file, args.output_res_file)
    return losses


if __name__ == "__main__":
    run()
