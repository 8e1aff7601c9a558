"""The port's ``Adam`` against the JAX package's ``adam`` (+
``optax.apply_updates``): 20 steps on the same numpy parameters and a seeded
gradient sequence, with per-parameter learning rates 0.01, 0 and None (the
default).  Tolerance rtol 1e-6, atol 1e-7: both run float32 in the same
expression order, but ``pow`` and ``sqrt`` come from two libraries."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neural_renderer_v2_pytorch_tpu as jnr
import neural_renderer_v2_pytorch_tpu_torch as tnr

LRS = {"a": 0.01, "b": 0.0, "c": None}
DEFAULT_LR = 0.003


def _inputs(seed=0, steps=20):
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(4, 3), "b": rng.randn(5), "c": rng.randn(2, 2, 2)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.randint(-3, 2)).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    return params, grads


def test_adam_matches_jax():
    params, grads = _inputs()
    opt = jnr.adam(lr=DEFAULT_LR, param_lrs=LRS)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)

    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    topt = tnr.Adam([{"params": [tp[k]], "lr": lr} for k, lr in LRS.items()], lr=DEFAULT_LR)
    assert tnr.adam is tnr.Adam
    for step, g in enumerate(grads):
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        topt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{k} at step {step}")
    # lr 0 freezes the parameter bit for bit; the others moved
    np.testing.assert_array_equal(tp["b"].detach().numpy(), params["b"])
    assert not np.array_equal(tp["a"].detach().numpy(), params["a"])
    assert not np.array_equal(tp["c"].detach().numpy(), params["c"])
    # the second moments stay >= 0, and match the JAX state's
    for k, p in tp.items():
        v = topt.state[p]["v"]
        assert bool((v >= 0).all())
        np.testing.assert_allclose(v.numpy(), np.asarray(state.nu[k]), rtol=1e-6, atol=0)


def test_adam_plain_parameters_and_closure():
    """Tensors instead of groups take the default lr; ``step`` returns the
    closure's loss; a parameter without a gradient is left alone."""
    params, grads = _inputs(1, 3)
    opt = jnr.adam(lr=0.05)
    jx = jnp.asarray(params["a"])
    state = opt.init(jx)
    x = torch.nn.Parameter(torch.tensor(params["a"]))
    idle = torch.nn.Parameter(torch.tensor(params["b"]))
    topt = tnr.Adam([x, idle], lr=0.05)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g["a"]), state)
        jx = optax.apply_updates(jx, updates)

        def closure(g=g):
            x.grad = torch.tensor(g["a"])
            return torch.tensor(1.5)

        assert float(topt.step(closure)) == 1.5
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(idle.detach().numpy(), params["b"])
    with pytest.raises(ValueError):
        tnr.Adam([x], lr=None)
