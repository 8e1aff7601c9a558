"""The port's hand-written CUDA kernels against their plain versions, on the
card.  Marked ``cuda``: each test skips without a CUDA device.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import icosphere, torus

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _soup_planar(seed, bs, nf, device):
    rng = np.random.RandomState(seed)
    fv = rng.uniform(-1, 1, (bs, nf, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    fv[:, 1] = fv[:, 0]                       # exact duplicate
    fv[:, 2, 1] = fv[:, 2, 0]                 # degenerate
    return torch.tensor(fv.transpose(0, 3, 2, 1).copy(), device=device)


@pytest.mark.parametrize("draw_backside", [True, False])
@pytest.mark.parametrize("bs,nf,size", [(2, 37, 64), (1, 300, 100), (3, 5, 17)])
def test_face_setup_and_resolve_are_bit_exact(cuda, bs, nf, size, draw_backside):
    fvp = _soup_planar(nf, bs, nf, cuda)
    consts = rc.face_setup(fvp, draw_backside)
    assert torch.equal(consts, rc.face_setup_plain(fvp, draw_backside))
    got = rc.resolve_xy(consts, fvp, size, 0.1, 100.0)
    want = rc.resolve_xy_plain(consts, fvp, size, 0.1, 100.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[0] >= 0).any()


def test_scatters_match_plain_versions(cuda):
    _, faces = icosphere(3)
    nv, nf = int(faces.max()) + 1, len(faces)
    f = torch.tensor(faces, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    g9 = torch.randn((2, 3, 3, nf), generator=gen, device=cuda)
    got = rc.scatter_faces_to_vertices(g9, f, nv)
    want = rc.scatter_faces_to_vertices_plain(g9, f, nv)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))

    fim = torch.randint(-1, nf, (2, 64, 64), generator=gen, device=cuda, dtype=torch.int32)
    g6 = torch.randn((2, 6, 64, 64), generator=gen, device=cuda)
    got = rc.scatter_pixels_to_faces(g6, fim, nf)
    want = rc.scatter_pixels_to_faces_plain(g6, fim, nf)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def test_slice_on_card_matches_cpu(cuda):
    """Same NDC vertices on the card and the CPU: images equal, gradients
    within the atomics' bound, and every kernel launched."""
    v, f = torus(16, 12)
    r = nr.Renderer("cpu")
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 20)
    ndc = r.transform_vertices(torch.tensor(v[None])).detach()
    out = []
    rc.reset_launches()
    for dev in ("cpu", cuda):
        x = ndc.detach().to(dev).requires_grad_(True)
        im = nr.rasterize_silhouettes(x, torch.tensor(f, device=dev), None,
                                      nr.RasterizeHyperparam(image_size=64))
        torch.sum(im * im).backward()
        out.append((im.detach().cpu(), x.grad.cpu()))
    assert all(n == 1 for n in rc.LAUNCHES.values()), rc.LAUNCHES
    renderer = nr.Renderer("cuda")                  # no index: the current card
    renderer.render_silhouettes(torch.tensor(v[None], device=cuda), f)
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[1][1], out[0][1], rtol=0,
                               atol=1e-4 * float(out[0][1].abs().max()))


def test_wrappers_reject_bad_inputs(cuda):
    fvp = _soup_planar(0, 1, 8, cuda)
    with pytest.raises(ValueError):
        rc.face_setup(fvp.double(), True)
    with pytest.raises(ValueError):
        rc.face_setup(fvp.transpose(1, 2), True)
    consts = rc.face_setup(fvp, True)
    with pytest.raises(ValueError):
        rc.resolve_xy(consts, fvp.cpu(), 16, 0.1, 100.0)
