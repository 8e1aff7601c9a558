"""``Mesh``: a trainable mesh loaded from an OBJ file (counterpart of
``neural_renderer_v2_pytorch_tpu/models/mesh.py``; reference
neural_renderer_torch/mesh.py:7-37).

``vertices`` and the per-face texture ``textures`` (nf, ts, ts, ts, 3) are
``nn.Parameter``s and ``faces`` an int32 buffer.  The 5-D texture is the
reference's v1-era parameter, which the v2 UV-atlas renderer does not take;
it is kept for the API, and :meth:`Mesh.init_uv_params` gives a
``create_textures`` atlas the renderer does take.  Per-parameter learning
rates (:meth:`Mesh.set_lr`) become ``utils.optim.Adam`` parameter groups
through :meth:`Mesh.param_groups`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.helpers import create_textures
from ..utils.obj_io import load_obj


class Mesh(nn.Module):
    def __init__(self, filename_obj, texture_size=4, normalization=True, device="cuda"):
        super().__init__()
        vertices, faces = load_obj(filename_obj, normalization, device=device)
        self.vertices = nn.Parameter(vertices)
        self.register_buffer("faces", faces)
        self.num_vertices = vertices.shape[0]
        self.num_faces = faces.shape[0]
        self.texture_size = texture_size
        # the v1 per-face texture (reference mesh.py:19-21), standard normal
        # from a generator seeded 0 (the JAX package draws from PRNGKey(0):
        # the same distribution, other numbers)
        shape = (self.num_faces, texture_size, texture_size, texture_size, 3)
        gen = torch.Generator().manual_seed(0)
        self.textures = nn.Parameter(torch.randn(shape, generator=gen).to(device))
        self.lr_vertices = None
        self.lr_textures = None

    def init_params(self):
        """The trainable parameters by name."""
        return {"vertices": self.vertices, "textures": self.textures}

    def init_uv_params(self, texture_size=None):
        """A ``create_textures`` atlas for the renderer: (vertices_t f32
        [nf*3, 2], faces_t i32 [nf, 3], textures f32 [3, H, W]) on the
        mesh's device."""
        ts = texture_size or self.texture_size
        return create_textures(self.num_faces, texture_size=ts, device=self.faces.device)

    def get_batch(self, batch_size, params=None):
        """(vertices [bs, nv, 3], faces [bs, nf, 3], sigmoid(textures)
        [bs, nf, ts, ts, ts, 3]), broadcast over the batch (reference
        mesh.py:28-33); ``params`` overrides the mesh's own parameters."""
        vertices = params["vertices"] if params else self.vertices
        textures = params["textures"] if params else self.textures
        return (vertices[None].expand(batch_size, *vertices.shape),
                self.faces[None].expand(batch_size, *self.faces.shape),
                torch.sigmoid(textures[None].expand(batch_size, *textures.shape)))

    def set_lr(self, lr_vertices, lr_textures):
        """Learning rates of the vertices and the textures (reference
        mesh.py:35-37): None takes the optimiser's default, 0 freezes."""
        self.lr_vertices = lr_vertices
        self.lr_textures = lr_textures

    def param_lrs(self):
        return {"vertices": self.lr_vertices, "textures": self.lr_textures}

    def param_groups(self):
        """:meth:`param_lrs` as parameter groups of ``utils.optim.Adam``."""
        params = self.init_params()
        return [{"params": [params[k]], "lr": lr} for k, lr in self.param_lrs().items()]
