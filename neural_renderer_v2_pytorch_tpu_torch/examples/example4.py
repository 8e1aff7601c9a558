"""Example 4: finding the camera position by gradient descent (reference
examples_pytorch/example4.py; JAX package examples/example4.py).

The trainable is the camera position itself: the gradient flows from the
image through the NMR backward, the vertices in camera space and
``look_at`` into it.  ``torch.optim.Adam(0.1)``; stops when the loss falls
below 70 scaled by (S / 256)^2 (example4.py:121).
"""

import argparse
import os
import types

import numpy as np
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr

START = (6.0, 10.0, -14.0)   # example4.py:32


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-io", "--input_obj_file", type=str, default="./data/torus.obj")
    parser.add_argument("-ir", "--input_ref_file", type=str, default="./data/example4_ref.png")
    parser.add_argument("-or", "--output_res_file", type=str, default="./data/example4_res.gif")
    parser.add_argument("-n", "--max_steps", type=int, default=1000)
    parser.add_argument("-s", "--image_size", type=int, default=256,
                        help="render size; the reference image is subsampled and the stop "
                             "threshold scaled")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def setup(args):
    """The fit's renderer, mesh, target and the initial camera position [3]
    (``param``), as a namespace."""
    device = torch.device(args.device)
    vertices, faces = nr.load_obj(args.input_obj_file, device=device)
    image_ref = nr.imread(args.input_ref_file)
    if image_ref.ndim == 3:
        image_ref = image_ref.mean(-1)
    k = image_ref.shape[0] // args.image_size
    if k * args.image_size != image_ref.shape[0]:
        raise ValueError(f"image size {args.image_size} does not divide the reference's "
                         f"{image_ref.shape[0]}")
    renderer = nr.Renderer(device)
    renderer.image_size = args.image_size
    return types.SimpleNamespace(
        renderer=renderer, vertices=vertices[None], faces=faces,
        param=torch.tensor(START, device=device),
        image_ref=torch.tensor(np.ascontiguousarray(image_ref[::k, ::k]), device=device))


def forward(fit, camera_position):
    """(silhouette [1, S, S], loss) from ``camera_position`` [3]."""
    fit.renderer.viewpoints = camera_position
    images = fit.renderer.render_silhouettes(fit.vertices, fit.faces)
    return images, torch.sum((images[0] - fit.image_ref) ** 2)


def run(argv=None, cameras=None):
    """The fit and its GIF; returns the loss of every step taken.  A list
    ``cameras`` gets the camera position (a list of 3 floats) after each
    step."""
    args = parse_arguments(argv)
    working_dir = os.path.dirname(args.output_res_file) or "."
    os.makedirs(working_dir, exist_ok=True)
    fit = setup(args)
    # the reference's stop (example4.py:121) is an L2 sum at 256^2
    stop_loss = 70.0 * (args.image_size / 256.0) ** 2

    camera_position = fit.param.clone().requires_grad_(True)
    opt = torch.optim.Adam([camera_position], lr=0.1)   # example4.py:100
    losses = []
    for i in range(args.max_steps):
        opt.zero_grad()
        _, loss = forward(fit, camera_position)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if cameras is not None:
            cameras.append(camera_position.tolist())
        with torch.no_grad():
            image = forward(fit, camera_position)[0][0]
        nr.imsave("%s/_tmp_%04d.png" % (working_dir, i), image.clamp(0, 1))
        if i % 10 == 0:
            print("step %d: loss %.1f camera %s"
                  % (i, losses[-1], camera_position.detach().cpu().numpy()))
        if losses[-1] < stop_loss:
            print("converged at step %d (loss %.1f)" % (i, losses[-1]))
            break

    nr.make_gif(working_dir, args.output_res_file)
    print("wrote", args.output_res_file)
    return losses


if __name__ == "__main__":
    run()
