"""K6, the texture-atlas gradient (``resolve_cuda.atlas_taps_grad``), on the
CPU: its plain version and the port's ``shading._AtlasTaps`` backward
against the VJP of the JAX package's ``_atlas_taps``, through its Pallas
scatter in interpret mode and through its XLA branch; and an emulation of
the kernel's order, which adds each tap's three channels straight at its
texel of the planar [bs, 3, T] gradient, against the plain version.

Tolerance: 1e-5 of the largest magnitude against JAX (the Pallas scatter
splits gradients into bf16 halves, ~2^-17 relative); 1e-6 of it for the
emulation, which sums in another order than the plain version (float32
rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu.ops.shading import _atlas_taps
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops import shading as ts

BS, P = 2, 1500
# (th, tw): an even and an odd atlas width
ATLASES = [(23, 40), (19, 37)]


def _inputs(seed, th, tw):
    """(flat atlas [bs, 3, T], idx00 i32 [bs, P], cotangent [bs, 4, 3, P]).
    idx00 holds -1 (background, whose cotangent is 0 as the sampler's
    masked output gives it), anchors past T - tw - 2 (clamped), anchors at
    the end of an atlas row (their +1 and +tw+1 taps cross into the next
    row) and anchors anywhere else."""
    rng = np.random.RandomState(seed)
    T = th * tw
    idx00 = rng.randint(0, T - tw - 2, size=(BS, P))
    kind = rng.randint(0, 8, size=(BS, P))
    idx00[kind == 0] = -1
    idx00[kind == 1] = rng.randint(T - tw - 2, T, size=int((kind == 1).sum()))
    row_end = rng.randint(0, th - 1, size=int((kind == 2).sum())) * tw + tw - 1
    idx00[kind == 2] = row_end
    cot = rng.randn(BS, 4, 3, P).astype(np.float32)
    cot[np.broadcast_to((idx00 < 0)[:, None, None], cot.shape)] = 0.0
    flat = rng.rand(BS, 3, T).astype(np.float32)
    return flat, idx00.astype(np.int32), cot


def _port_anchors(idx00, tw, T):
    """The anchors ``_AtlasTaps`` saves: clamped to [0, T - tw - 2], -1 on
    background."""
    return np.where(idx00 < 0, -1, np.clip(idx00, 0, T - tw - 2)).astype(np.int32)


def _close(got, want, rel):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("kernel_bwd", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("th,tw", ATLASES)
def test_plain_and_autograd_match_the_jax_vjp(th, tw, kernel_bwd):
    T = th * tw
    flat, idx00, cot = _inputs(th + tw, th, tw)
    _, vjp = jax.vjp(lambda f: _atlas_taps(f, jnp.asarray(idx00), tw, kernel_bwd),
                     jnp.asarray(flat))
    (want,) = vjp(jnp.asarray(cot))
    want = np.asarray(want)
    assert want.shape == (BS, 3, T) and np.abs(want).max() > 0

    got = rc.atlas_taps_grad_plain(torch.tensor(cot.reshape(BS, 12, P)),
                                   torch.tensor(_port_anchors(idx00, tw, T)), tw, T)
    assert got.is_contiguous()
    _close(got.numpy(), want, 1e-5)

    x = torch.tensor(flat, requires_grad=True)
    taps = ts._AtlasTaps.apply(x, torch.tensor(idx00), tw)
    taps.backward(torch.tensor(cot))
    # the Function's gradient is the plain version's, in the atlas's layout
    assert torch.equal(x.grad, got) and x.grad.is_contiguous()


def _emulate_kernel(grad, anchors, tw, T, order):
    """The kernel's adds, one (image, pixel) thread at a time in ``order``
    (a permutation of the pixels), each thread's taps channel by channel
    as the kernel sends them: a then a + 1, then a + tw then a + tw + 1,
    each in float32 straight into [bs, 3, T]; an anchor outside [0, T)
    adds nothing, and a tap past T is dropped."""
    bs = grad.shape[0]
    out = np.zeros((bs, 3, T), np.float32)
    for b in range(bs):
        for p in order:
            a = int(anchors[b, p])
            if not 0 <= a < T:
                continue
            for c in range(3):
                for i, k in enumerate((0, 1, tw, tw + 1)):
                    if a + k < T:
                        out[b, c, a + k] += grad[b, 3 * i + c, p]
    return out


@pytest.mark.parametrize("th,tw", ATLASES)
def test_kernel_order_emulation_matches_the_plain_version(th, tw):
    """Tap by tap in a seeded order, against the 12-channel scatter and
    fold; anchors past T - tw - 2 (taps dropped at the end of the atlas),
    at T and beyond (nothing added) and -1 included."""
    T = th * tw
    _, idx00, cot = _inputs(th * tw, th, tw)
    anchors = _port_anchors(idx00, tw, T)
    rng = np.random.RandomState(tw)
    edge = rng.rand(BS, P) < 0.05
    anchors[edge] = rng.randint(T - tw - 2, T + 3, size=int(edge.sum()))
    grad = cot.reshape(BS, 12, P)
    got = _emulate_kernel(grad, anchors, tw, T, rng.permutation(P))
    want = rc.atlas_taps_grad_plain(torch.tensor(grad), torch.tensor(anchors), tw, T).numpy()
    assert np.abs(want[:, :, T - tw - 1:]).max() > 0     # the end of the atlas is reached
    _close(got, want, 1e-6)
