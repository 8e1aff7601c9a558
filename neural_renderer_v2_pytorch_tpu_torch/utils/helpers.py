"""Image I/O, GIF assembly, moving data to a device, texture atlases and
spherical camera placement (counterpart of
``neural_renderer_v2_pytorch_tpu/utils/helpers.py``; reference
utils.py:10-72)."""

from __future__ import annotations

import glob
import os

import numpy as np
import torch


def read_image(filename):
    """An image file as a uint8 array [H, W] or [H, W, C], as imageio reads
    it through Pillow (a palette image as RGB, or RGBA with transparency).
    The port calls Pillow itself, so imageio is not one of its dependencies."""
    from PIL import Image

    with Image.open(filename) as img:
        if img.mode == "P":
            img = img.convert("RGBA" if "transparency" in img.info else "RGB")
        return np.asarray(img)


def write_image(filename, image):
    """Write a uint8 array [H, W] or [H, W, C] (C 3 or 4) with Pillow."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(image)).save(filename)


def make_gif(working_directory, filename):
    """Assemble the ``_tmp_*.png`` frames of ``working_directory``, in name
    order, into the GIF ``filename`` (80 ms a frame, looping), then delete
    the frames.  Does nothing when there is no frame."""
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(working_directory, "_tmp_*.png")))
    if not paths:
        return
    frames = [Image.fromarray(read_image(f)) for f in paths]
    frames[0].save(filename, save_all=True, append_images=frames[1:], duration=80, loop=0)
    for f in paths:
        os.remove(f)


def to_device(data, device="cuda"):
    """``data`` (a numpy array, a tensor or a number, or a list or tuple of
    them) as tensor(s) on ``device``; a list or tuple gives a list (the
    reference's ``to_gpu``, utils.py:18-22)."""
    if isinstance(data, (tuple, list)):
        return [torch.as_tensor(d, device=device) for d in data]
    return torch.as_tensor(data, device=device)


# the reference's name
to_gpu = to_device


def imread(filename):
    """An image as float32 in [0, 1], [H, W] or [H, W, C] (utils.py:25-27)."""
    return np.asarray(read_image(filename), dtype=np.float32) / 255.0


def imsave(filename, image):
    """Write an image: a float array or tensor in [0, 1] (clipped, scaled to
    uint8) or a uint8 one."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    write_image(filename, image)


def create_textures(num_faces, texture_size=16, flatten=False, device="cuda"):
    """A white tiled atlas with one ``texture_size`` square patch per face,
    and each face's texel-coordinate triangle in its patch (reference
    utils.py:30-52).  Returns tensors on ``device``: (vertices_t f32
    [nf*3, 2], faces_t i32 [nf, 3], textures f32 [3, H, W])."""
    if not flatten:
        tile_width = int((num_faces - 1.0) ** 0.5) + 1
        tile_height = int((num_faces - 1.0) / tile_width) + 1
    else:
        tile_width = 1
        tile_height = num_faces
    textures = np.ones((3, tile_height * texture_size, tile_width * texture_size), np.float32)

    vertices = np.zeros((num_faces, 3, 2), np.float32)  # [:, :, XY]
    face_nums = np.arange(num_faces)
    column = face_nums % tile_width
    row = face_nums // tile_width
    vertices[:, 0, 0] = column * texture_size
    vertices[:, 0, 1] = row * texture_size
    vertices[:, 1, 0] = column * texture_size
    vertices[:, 1, 1] = (row + 1) * texture_size - 1
    vertices[:, 2, 0] = (column + 1) * texture_size - 1
    vertices[:, 2, 1] = (row + 1) * texture_size - 1
    faces = np.arange(num_faces * 3).reshape((num_faces, 3))
    return (
        torch.tensor(vertices.reshape(num_faces * 3, 2), device=device),
        torch.tensor(faces, dtype=torch.int32, device=device),
        torch.tensor(textures, device=device),
    )


def get_points_from_angles(distance, elevation, azimuth, degrees=True):
    """Spherical -> cartesian camera position.

    Python-scalar inputs return a plain float tuple; tensor inputs return a
    differentiable [..., 3] float32 tensor on the device of the first tensor
    argument.  The tensor branch keeps the reference's low-precision
    degree/radian constant (3.14159265359/180).
    """
    args = (distance, elevation, azimuth)
    if all(isinstance(a, (float, int)) for a in args):
        if degrees:
            elevation = np.radians(elevation)
            azimuth = np.radians(azimuth)
        return (
            distance * np.cos(elevation) * np.sin(azimuth),
            distance * np.sin(elevation),
            -distance * np.cos(elevation) * np.cos(azimuth),
        )
    devices = [a.device for a in args if isinstance(a, torch.Tensor)]
    if not devices:
        raise TypeError("pass python numbers, or at least one tensor to fix the device")
    device = devices[0]
    distance, elevation, azimuth = (
        torch.as_tensor(a, dtype=torch.float32, device=device) for a in args
    )
    if degrees:
        elevation = elevation / 180.0 * 3.14159265359
        azimuth = azimuth / 180.0 * 3.14159265359
    return torch.stack(
        [
            distance * torch.cos(elevation) * torch.sin(azimuth),
            distance * torch.sin(elevation),
            -distance * torch.cos(elevation) * torch.cos(azimuth),
        ],
        dim=-1,
    )
