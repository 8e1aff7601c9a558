"""Example 5: a sharded vertex fit over a (data, tile, face) rank mesh
(JAX package examples/example5_sharded.py; the reference has none).

Each rank is a process of its own (``parallel.run_ranks``): the batch of
camera views splits over ``data``, the image rows over ``tile`` and, from
8 ranks on, the resolve's faces over ``face``; one all-reduce sums the
gradients, so every rank takes the same Adam steps.  Ranks that share a
card (or run on the CPU) talk through gloo, else NCCL.  The parent then
renders a turntable of the result into a GIF::

    python -m neural_renderer_v2_pytorch_tpu_torch.examples.example5_sharded --ranks 2
"""

import argparse
import os
import tempfile

import numpy as np
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu_torch import parallel
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda

# seconds the ranks may take, start-up and every collective included
TIMEOUT = 600.0


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--input_file", type=str, default="./data/torus.obj")
    p.add_argument("-o", "--output_file", type=str, default="./data/example5.gif")
    p.add_argument("-n", "--num_steps", type=int, default=60)
    p.add_argument("-s", "--image_size", type=int, default=128)
    p.add_argument("--ranks", type=int, default=2, help="ranks, one process each")
    # each rank takes a card of its own (or shares one): no card index
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def mesh_shape(n):
    """(data, tile, face) over ``n`` ranks, as the JAX example splits its
    devices: a data axis of 2 from 4 ranks on, a face axis of 2 when at
    least 4 ranks remain, the rest on tile."""
    data = 2 if n >= 4 and n % 2 == 0 else 1
    face = 2 if n // data >= 4 and (n // data) % 2 == 0 else 1
    return data, n // (data * face), face


def first_step(render, v, target):
    """One step's images and vertex gradient from ``v``: (images, grad),
    both on the CPU."""
    x = v.detach().clone().requires_grad_(True)
    images = render(x)
    torch.mean((images - target) ** 2).backward()
    return images.detach().cpu(), x.grad.cpu()


def fit_rank(input_file, image_size, num_steps, device, vs_plain=False):
    """One rank's share of the fit (run by ``parallel.run_ranks``): returns
    its mesh shape, the loss of every step, the fitted vertices, its kernel
    launches over the fit and the vertex -> slot tables K4 built.  With
    ``vs_plain``, also its first step (:func:`first_step`) with the kernels
    and with their plain versions, under ``first_step``; those launches are
    not counted."""
    import torch.distributed as dist

    from neural_renderer_v2_pytorch_tpu_torch.ops.camera import look_at, perspective

    dev = torch.device("cpu") if device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    shape = mesh_shape(dist.get_world_size())
    mesh = parallel.make_mesh(*shape)
    vertices, faces = nr.load_obj(input_file, device=dev)
    bs = 2 * shape[0]
    eyes = torch.tensor(np.stack([
        np.array(nr.get_points_from_angles(2.732, 30, a), "float32")
        for a in np.linspace(0, 360, bs, endpoint=False)
    ]), device=dev)
    hp = nr.RasterizeHyperparam(image_size=image_size, anti_aliasing=False)

    def render(v):
        vb = v[None].expand(bs, -1, -1)
        return parallel.rasterize_silhouettes_sharded(
            perspective(look_at(vb, eyes), angle=30.0), faces, None, hp, mesh=mesh)

    # the target: the sharded render of the mesh as loaded
    with torch.no_grad():
        target = render(vertices)
    # fit perturbed vertices back to it, sharded end to end
    rng = np.random.RandomState(0)
    noise = 0.05 * rng.randn(*vertices.shape).astype("float32")
    v = (vertices + torch.tensor(noise, device=dev)).requires_grad_(True)
    checked = {}
    if vs_plain:
        checked["kernels"] = first_step(render, v, target)
        with resolve_cuda.plain_versions():
            checked["plain"] = first_step(render, v, target)
    opt = torch.optim.Adam([v], lr=5e-3)
    resolve_cuda.reset_launches()
    losses = []
    for i in range(num_steps):
        opt.zero_grad()
        loss = torch.mean((render(v) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if dist.get_rank() == 0 and (i % 10 == 0 or i == num_steps - 1):
            print(f"step {i}: loss {losses[-1]:.6f}", flush=True)
    return dict(mesh=shape, losses=losses, vertices=v.detach().cpu().numpy(),
                launches={k: n for k, n in resolve_cuda.LAUNCHES.items() if n},
                slot_tables=resolve_cuda.SLOT_TABLE_BUILDS, first_step=checked)


def fit(args, vs_plain=False):
    """Run :func:`fit_rank` on ``args.ranks`` ranks (``vs_plain`` as there);
    returns each rank's result.  Raises when a rank's fitted vertices are not
    rank 0's bits."""
    # NCCL takes one rank per card
    gloo = args.device == "cpu" or args.ranks > torch.cuda.device_count()
    backend = "gloo" if gloo else "nccl"
    ranks = parallel.run_ranks(fit_rank, args.ranks,
                               (args.input_file, args.image_size, args.num_steps, args.device,
                                vs_plain),
                               device=args.device, backend=backend, timeout=TIMEOUT)
    for rank, r in enumerate(ranks):
        if not np.array_equal(r["vertices"], ranks[0]["vertices"]):
            raise RuntimeError(f"rank {rank}'s fitted vertices are not rank 0's")
    print(f"ranks: {args.ranks} ({backend}), mesh (data, tile, face): {ranks[0]['mesh']}")
    return ranks


def write_turntable(args, vertices):
    """A GIF of ``vertices`` (the fitted mesh) from 12 azimuths, rendered
    on one device."""
    device = torch.device(args.device)
    _, faces = nr.load_obj(args.input_file, device=device)
    renderer = nr.Renderer(device)
    renderer.image_size = args.image_size
    v = torch.tensor(vertices, device=device)[None]
    os.makedirs(os.path.dirname(args.output_file) or ".", exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        for i, az in enumerate(range(0, 360, 30)):
            renderer.viewpoints = nr.get_points_from_angles(2.732, 30, az)
            nr.imsave(os.path.join(tmp, "_tmp_%04d.png" % i),
                      renderer.render_silhouettes(v, faces)[0])
        nr.make_gif(tmp, args.output_file)
    print("wrote", args.output_file)


def main(argv=None):
    """The sharded fit and its GIF; returns the loss of every step."""
    args = parse_args(argv)
    ranks = fit(args)
    write_turntable(args, ranks[0]["vertices"])
    return ranks[0]["losses"]


if __name__ == "__main__":
    main()
