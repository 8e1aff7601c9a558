"""Wavefront OBJ / MTL I/O and texture-atlas packing (counterpart of
``neural_renderer_v2_pytorch_tpu/utils/obj_io.py``).

The files are parsed on the host with numpy, in the JAX package's steps, so
both packages load the same numbers; ``load_obj`` then hands back tensors on
``device``.  The semantics are the reference loader's
(neural_renderer_torch/load_obj.py, save_obj.py):

  * polygon faces are fan-triangulated;
  * vertices are normalized into a centred ~unit-2 cube (min-shift,
    /max|.|, *2, -max/2);
  * material textures are stacked vertically into one atlas, widths padded
    with zeros; a flat-``Kd`` material becomes a 2x2 colour patch with three
    UV vertices of its own;
  * UVs are scaled to texel coordinates (times width-1 / height-1, offset by
    the material's row in the atlas);
  * texture rows are flipped at load (image origin top-left, UV origin
    bottom-left);
  * ``save_obj`` writes v/vt/f + .mtl + .png, with UVs back in [0, 1].

The geometry pass uses the C++ parser (``utils/native_loader.py``) where it
builds, else a Python tokenizer with the same result.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .helpers import read_image, write_image
from .native_loader import parse_obj_native


def load_mtl(filename_mtl):
    """``{material: {"color": f64 [3]} or {"texture_filename": str}}`` from
    the newmtl / Kd / map_Kd lines (reference load_obj.py:7-22)."""
    materials = {}
    material_name = ""
    with open(filename_mtl) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                material_name = parts[1]
                materials[material_name] = {}
            elif parts[0] == "map_Kd":
                materials[material_name]["texture_filename"] = parts[1]
            elif parts[0] == "Kd":
                materials[material_name]["color"] = np.array([float(v) for v in parts[1:4]])
    return materials


def _load_textures_numpy(filename_obj, filename_mtl):
    """(vertices_t f32 [nvt, 2] texel coordinates, faces_t i32 [nf, 3],
    textures f32 [3, H, W] in [0, 1]) as numpy arrays."""
    vertices = []
    with open(filename_obj) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "vt":
                vertices.append([float(v) for v in parts[1:3]])
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 2)

    # UV faces and each face's material, fan-triangulated
    faces = []
    material_names = []
    material_name = ""
    with open(filename_obj) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "f":
                vs = parts[1:]
                uv_ids = [int(v.split("/")[1]) if "/" in v else 0 for v in vs]
                for i in range(len(vs) - 2):
                    faces.append((uv_ids[0], uv_ids[i + 1], uv_ids[i + 2]))
                    material_names.append(material_name)
            elif parts[0] == "usemtl":
                material_name = parts[1]
    faces = np.asarray(faces, dtype=np.int32) - 1
    material_names = np.asarray(material_names)

    materials = load_mtl(filename_mtl)

    # one atlas, the materials stacked vertically; UVs to texel coordinates
    pos = 0
    atlas = np.zeros((3, 0, 0), dtype=np.float32)
    for material_name, material in materials.items():
        if "texture_filename" in material:
            texture = read_image(
                os.path.join(os.path.dirname(filename_mtl), material["texture_filename"])
            )
            texture = texture.astype(np.float32) / 255.0
            if texture.ndim == 2:
                texture = np.stack([texture] * 3, axis=-1)
            texture = texture[:, :, :3].transpose(2, 0, 1)
            texture = texture[:, ::-1, :]  # image rows -> UV rows

            indices = np.unique(faces[material_names == material_name].flatten())
            vertices[indices, 0] *= texture.shape[2] - 1
            vertices[indices, 1] *= texture.shape[1] - 1
            vertices[indices, 1] += pos
        else:
            color = material["color"]
            texture = np.ones((3, 2, 2), dtype=np.float32) * color[:, None, None]
            # three UV vertices of its own, in the 2x2 patch
            extra = np.zeros((3, 2), dtype=np.float32)
            extra[0] = (0, pos)
            extra[1] = (0, pos + 1)
            extra[2] = (1, pos + 1)
            vertices = np.concatenate((vertices, extra), axis=0)
            n = vertices.shape[0]
            faces[material_names == material_name] = np.array([n - 3, n - 2, n - 1])

        pos += texture.shape[1]
        if atlas.shape[2] < texture.shape[2]:
            atlas = np.concatenate(
                (atlas, np.zeros((3, atlas.shape[1], texture.shape[2] - atlas.shape[2]),
                                 np.float32)),
                axis=2,
            )
        elif texture.shape[2] < atlas.shape[2]:
            texture = np.concatenate(
                (texture, np.zeros((3, texture.shape[1], atlas.shape[2] - texture.shape[2]),
                                   np.float32)),
                axis=2,
            )
        atlas = np.concatenate((atlas, texture), axis=1).astype(np.float32)

    return vertices.astype(np.float32), faces, atlas


def load_textures(filename_obj, filename_mtl, device="cuda"):
    """UV vertices and faces of ``filename_obj`` and every material of
    ``filename_mtl`` packed into one atlas (reference load_obj.py:25-110):
    (vertices_t f32 [nvt, 2] texel coordinates, faces_t i32 [nf, 3],
    textures f32 [3, H, W] in [0, 1]), tensors on ``device``."""
    vertices_t, faces_t, textures = _load_textures_numpy(filename_obj, filename_mtl)
    return (torch.tensor(vertices_t, device=device), torch.tensor(faces_t, device=device),
            torch.tensor(textures, device=device))


def _parse_geometry_python(filename_obj):
    vertices = []
    faces = []
    with open(filename_obj) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(v) for v in parts[1:4]])
            elif parts[0] == "f":
                vs = parts[1:]
                ids = [int(v.split("/")[0]) for v in vs]
                for i in range(len(vs) - 2):
                    faces.append((ids[0], ids[i + 1], ids[i + 2]))
    return (np.asarray(vertices, dtype=np.float32).reshape(-1, 3),
            np.asarray(faces, dtype=np.int32).reshape(-1, 3) - 1)


def load_obj(filename_obj, normalization=True, load_textures_flag=None, *,
             load_textures=False, device="cuda"):
    """Load a Wavefront .obj file (reference load_obj.py:113-166).

    Returns (vertices f32 [nv, 3], faces i32 [nf, 3]) or, with
    ``load_textures``, (vertices, faces, vertices_t, faces_t, textures), the
    last three as :func:`load_textures` gives them; all tensors on
    ``device``.  The faces are int32, as the renderer takes them, so a fit
    that passes them every step keeps one gradient table
    (``Renderer.faces_on_device``).  ``load_textures_flag`` is the third
    positional argument of the reference's signature."""
    if load_textures_flag is not None:
        load_textures = load_textures_flag

    mtl_name = None
    with open(filename_obj) as f:
        for line in f:
            if line.startswith("mtllib"):
                mtl_name = line.split()[1]
                break

    native = parse_obj_native(filename_obj)
    if native is not None:
        vertices, faces = native[0], native[1]
    else:
        vertices, faces = _parse_geometry_python(filename_obj)

    if load_textures:
        if mtl_name is None:
            raise RuntimeError(f"Failed to load textures (no mtllib in {filename_obj}).")
        filename_mtl = os.path.join(os.path.dirname(filename_obj), mtl_name)
        textured = _load_textures_numpy(filename_obj, filename_mtl)

    # into a centred ~unit-2 cube (reference load_obj.py:157-161)
    if normalization:
        vertices = vertices - vertices.min(0)[None, :]
        vertices = vertices / np.abs(vertices).max()
        vertices = vertices * 2
        vertices = vertices - vertices.max(0)[None, :] / 2

    out = [vertices, faces] + (list(textured) if load_textures else [])
    return tuple(torch.tensor(a, device=device) for a in out)


def _numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_obj(filename, vertices, faces, vertices_t=None, faces_t=None, textures=None):
    """Write a mesh as ``filename`` (.obj), and with ``textures`` [3, H, W]
    its atlas as ``.png`` and an ``.mtl`` naming it (reference
    save_obj.py:5-47).  Tensors or arrays; ``vertices_t`` in texel
    coordinates, written back in [0, 1]; the atlas rows flipped back to
    image order."""
    vertices = _numpy(vertices)
    faces = _numpy(faces)
    if vertices.ndim != 2 or faces.ndim != 2:
        raise ValueError(f"want vertices [nv, 3] and faces [nf, 3], got {vertices.shape} "
                         f"and {faces.shape}")

    filename_mtl = filename[:-4] + ".mtl"
    filename_texture = filename[:-4] + ".png"
    material_name = "material_1"

    if textures is not None:
        textures = _numpy(textures)
        tex_u8 = np.clip(textures[:, ::-1, :].transpose(1, 2, 0) * 255.0, 0, 255)
        write_image(filename_texture, tex_u8.astype(np.uint8))

    with open(filename, "w") as f:
        f.write("# %s\n" % os.path.basename(filename))
        f.write("#\n")
        f.write("\n")

        if textures is not None:
            f.write("mtllib %s\n\n" % os.path.basename(filename_mtl))

        for vertex in vertices:
            f.write("v %.8f %.8f %.8f\n" % (vertex[0], vertex[1], vertex[2]))
        f.write("\n")

        if textures is not None:
            vertices_t = np.array(_numpy(vertices_t), dtype=np.float32, copy=True)
            vertices_t[:, 0] /= textures.shape[2] - 1
            vertices_t[:, 1] /= textures.shape[1] - 1
            for vertex in vertices_t.reshape(-1, 2):
                f.write("vt %.8f %.8f\n" % (vertex[0], vertex[1]))
            f.write("\n")
            f.write("usemtl %s\n" % material_name)
            for face, face_t in zip(faces, _numpy(faces_t)):
                f.write(
                    "f %d/%d %d/%d %d/%d\n"
                    % (face[0] + 1, face_t[0] + 1, face[1] + 1, face_t[1] + 1,
                       face[2] + 1, face_t[2] + 1)
                )
            f.write("\n")
        else:
            for face in faces:
                f.write("f %d %d %d\n" % (face[0] + 1, face[1] + 1, face[2] + 1))

    if textures is not None:
        with open(filename_mtl, "w") as f:
            f.write("newmtl %s\n" % material_name)
            f.write("map_Kd %s\n" % os.path.basename(filename_texture))
