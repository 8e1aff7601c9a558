"""The port's ``Mesh`` against the JAX package's, on an OBJ this test
writes: vertices, faces and the UV bundle equal; the random v1 textures
(drawn by torch, not by jax.random) by shape and statistics."""

import numpy as np
import torch

import neural_renderer_v2_pytorch_tpu as jnr
import neural_renderer_v2_pytorch_tpu_torch as tnr
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import torus


def _obj(tmp_path):
    v, f = torus(8, 6)
    path = tmp_path / "torus.obj"
    with open(path, "w") as fh:
        fh.writelines("v %.8f %.8f %.8f\n" % tuple(p) for p in v)
        fh.writelines("f %d %d %d\n" % tuple(t + 1) for t in f)
    return str(path), len(f)


def test_mesh_matches_jax(tmp_path):
    path, nf = _obj(tmp_path)
    jm = jnr.Mesh(path, texture_size=4)
    tm = tnr.Mesh(path, texture_size=4, device="cpu")
    assert isinstance(tm, torch.nn.Module)
    np.testing.assert_array_equal(tm.vertices.detach().numpy(), np.asarray(jm.vertices))
    np.testing.assert_array_equal(tm.faces.numpy(), np.asarray(jm.faces))
    assert tm.faces.dtype == torch.int32 and (tm.num_vertices, tm.num_faces) == (48, nf)
    # parameters and the faces buffer, as nn.Module sees them
    assert {n for n, _ in tm.named_parameters()} == {"vertices", "textures"}
    assert {n for n, _ in tm.named_buffers()} == {"faces"}

    t = tm.textures.detach()
    assert t.shape == (nf, 4, 4, 4, 3) == tuple(jm.textures.shape)
    assert abs(float(t.mean())) < 0.05 and abs(float(t.std()) - 1.0) < 0.05
    # seeded: a second mesh draws the same textures
    assert torch.equal(tnr.Mesh(path, texture_size=4, device="cpu").textures, tm.textures)

    for got, want in zip(tm.init_uv_params(), jm.init_uv_params()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tm.init_uv_params(2), jm.init_uv_params(2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_get_batch_and_learning_rates(tmp_path):
    path, nf = _obj(tmp_path)
    tm = tnr.Mesh(path, texture_size=2, device="cpu")
    jm = jnr.Mesh(path, texture_size=2)
    v, f, t = tm.get_batch(3)
    jv, jf, jt = jm.get_batch(3)
    assert v.shape == jv.shape and f.shape == jf.shape and t.shape == jt.shape
    assert torch.equal(t[2], torch.sigmoid(tm.textures))
    np.testing.assert_array_equal(f[1].numpy(), np.asarray(jf[1]))
    params = {"vertices": tm.vertices * 2, "textures": torch.zeros_like(tm.textures)}
    v2, _, t2 = tm.get_batch(2, params)
    assert torch.equal(v2[1], tm.vertices * 2) and bool((t2 == 0.5).all())

    tm.set_lr(0.01, 0)
    jm.set_lr(0.01, 0)
    assert tm.param_lrs() == jm.param_lrs() == {"vertices": 0.01, "textures": 0}
    opt = tnr.Adam(tm.param_groups(), lr=0.1)
    textures0, vertices0 = tm.textures.detach().clone(), tm.vertices.detach().clone()
    for _ in range(3):
        opt.zero_grad()
        vb, _, tb = tm.get_batch(1)
        (vb.sum() + tb.sum()).backward()
        opt.step()
    assert torch.equal(tm.textures.detach(), textures0)      # lr 0: frozen
    assert not torch.equal(tm.vertices.detach(), vertices0)
