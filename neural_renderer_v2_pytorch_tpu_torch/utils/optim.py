"""Adam with a learning rate per parameter group (counterpart of
``neural_renderer_v2_pytorch_tpu/utils/optim.py``; the reference's AdamRule,
neural_renderer_chainer/optimizers.py:6-37).

A group's ``lr`` of None takes the optimiser's default; a group whose lr is
0 takes no update (its moments still advance, as in the JAX package); the
second moment is clamped at v >= 0.  The update is the JAX package's, in
its order and in float32::

    m = b1 m + (1 - b1) g;  v = max(b2 v + (1 - b2) g g, 0)
    p += -lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
"""

from __future__ import annotations

import torch

from . import trace


class Adam(torch.optim.Optimizer):
    """``Adam(params, lr=0.001, beta1=0.9, beta2=0.999, eps=1e-8)``.

    ``params``: tensors, or parameter groups (dicts with ``"params"`` and
    optionally ``"lr"``: None for the default, 0 to freeze), as
    ``Mesh.param_groups()`` gives them."""

    def __init__(self, params, lr=0.001, beta1=0.9, beta2=0.999, eps=1e-8):
        if lr is None:
            raise ValueError("the default learning rate cannot be None")
        super().__init__(params, dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps))
        for group in self.param_groups:
            if group["lr"] is None:
                group["lr"] = lr
        # one step count for every parameter, as the JAX package's state
        self.state["count"] = 0

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        with trace.span("update", step=self.state["count"]):
            self.state["count"] += 1
            for group in self.param_groups:
                b1, b2, eps, lr = group["beta1"], group["beta2"], group["eps"], group["lr"]
                for p in group["params"]:
                    if p.grad is None:
                        continue
                    g = p.grad
                    state = self.state[p]
                    if not state:
                        state["m"] = torch.zeros_like(p)
                        state["v"] = torch.zeros_like(p)
                    t = torch.tensor(float(self.state["count"]), dtype=torch.float32,
                                     device=p.device)
                    m = b1 * state["m"] + (1 - b1) * g
                    v = torch.clamp(b2 * state["v"] + (1 - b2) * g * g, min=0.0)
                    state["m"], state["v"] = m, v
                    if lr == 0:
                        continue
                    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=p.device), t)
                    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=p.device), t)
                    p.add_(-lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        return loss


# the JAX package's (and the reference's) lower-case name
adam = Adam
