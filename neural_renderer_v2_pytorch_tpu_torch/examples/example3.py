"""Example 3: optimising a texture atlas under random viewpoints (reference
examples_pytorch/example3.py; JAX package examples/example3.py).

A tanh-squashed ``create_textures`` atlas (texture size 4), an orthographic
camera (``renderer.perspective = False``), a random azimuth each step from
a ``torch.Generator`` seeded 0, and the port's ``Adam(0.01)``.  The
per-step losses are taken at random views and do not compare step to step:
the returned series is the loss at a fixed view before and after the fit.
"""

import argparse
import os
import types

import numpy as np
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import EXAMPLE3_VIEW

# the fixed view the losses are taken at, which write_example_data renders
# example3_ref.png from
CAMERA_DISTANCE, ELEVATION, EVAL_AZIMUTH = EXAMPLE3_VIEW
TEXTURE_SIZE = 4


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-io", "--input_obj_file", type=str, default="./data/torus.obj")
    parser.add_argument("-ir", "--input_ref_file", type=str, default="./data/example3_ref.png")
    parser.add_argument("-or", "--output_res_file", type=str, default="./data/example3_res.gif")
    parser.add_argument("-n", "--num_steps", type=int, default=300)
    parser.add_argument("-s", "--image_size", type=int, default=256,
                        help="render size; the reference image is subsampled to match")
    parser.add_argument("--sweep_step", type=int, default=4,
                        help="azimuth stride of the final turntable")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def setup(args):
    """The fit's renderer, mesh, texel coordinates, target and the initial
    texture parameter [1, 3, th, tw] (``param``), as a namespace."""
    device = torch.device(args.device)
    vertices, faces = nr.load_obj(args.input_obj_file, device=device)
    vertices_t, faces_t, textures = nr.create_textures(faces.shape[0],
                                                       texture_size=TEXTURE_SIZE, device=device)
    image_ref = nr.imread(args.input_ref_file)[..., :3]
    k = image_ref.shape[0] // args.image_size
    if k * args.image_size != image_ref.shape[0]:
        raise ValueError(f"image size {args.image_size} does not divide the reference's "
                         f"{image_ref.shape[0]}")
    renderer = nr.Renderer(device)
    renderer.image_size = args.image_size
    renderer.perspective = False            # orthographic (example3.py:40)
    renderer.texture_size = TEXTURE_SIZE    # sample each face's latched texel patch
    renderer.viewpoints = nr.get_points_from_angles(CAMERA_DISTANCE, ELEVATION, EVAL_AZIMUTH)
    ref = np.ascontiguousarray(image_ref[::k, ::k].transpose(2, 0, 1))
    return types.SimpleNamespace(
        renderer=renderer, vertices=vertices[None], faces=faces, vertices_t=vertices_t[None],
        faces_t=faces_t, param=textures[None], image_ref=torch.tensor(ref, device=device))


def forward(fit, texture_param):
    """(RGB [1, 3, S, S], loss) of the atlas ``tanh(texture_param)`` from the
    renderer's current view."""
    images = fit.renderer.render_rgb(fit.vertices, fit.faces, fit.vertices_t, fit.faces_t,
                                     torch.tanh(texture_param))
    return images, torch.sum((images[0] - fit.image_ref) ** 2)


def run(argv=None):
    """The fit and its turntable GIF; returns [loss before, loss after] at
    the fixed view (``EVAL_AZIMUTH``)."""
    args = parse_arguments(argv)
    working_dir = os.path.dirname(args.output_res_file) or "."
    os.makedirs(working_dir, exist_ok=True)
    fit = setup(args)
    eval_view = fit.renderer.viewpoints

    def eval_loss(param):
        fit.renderer.viewpoints = eval_view
        with torch.no_grad():
            return float(forward(fit, param)[1])

    texture_param = fit.param.clone().requires_grad_(True)
    opt = nr.Adam([texture_param], lr=0.01)
    gen = torch.Generator().manual_seed(0)
    losses = [eval_loss(texture_param)]
    for i in range(args.num_steps):
        azimuth = float(torch.rand((), generator=gen)) * 360.0
        fit.renderer.viewpoints = nr.get_points_from_angles(CAMERA_DISTANCE, ELEVATION, azimuth)
        opt.zero_grad()
        _, loss = forward(fit, texture_param)
        loss.backward()
        opt.step()
        if i % 20 == 0 or i == args.num_steps - 1:
            print("step %d: loss %.3f" % (i, loss.item()))
    losses.append(eval_loss(texture_param))
    print("eval loss (fixed view): %.3f -> %.3f" % (losses[0], losses[-1]))

    with torch.no_grad():
        for num, azimuth in enumerate(range(0, 360, args.sweep_step)):
            fit.renderer.viewpoints = nr.get_points_from_angles(CAMERA_DISTANCE, ELEVATION,
                                                                azimuth)
            image = forward(fit, texture_param)[0][0].permute(1, 2, 0).clamp(min=0)
            nr.imsave("%s/_tmp_%04d.png" % (working_dir, num), image)
    nr.make_gif(working_dir, args.output_res_file)
    print("wrote", args.output_res_file)
    return losses


if __name__ == "__main__":
    run()
