"""Plain Adam and the readings of the first training steps.

Adam as ``torch.optim.Adam`` states it (betas 0.9, 0.999, eps 1e-8, bias
corrected), written out. :func:`replay` runs a loss function over a few
steps and returns what the harness compares: each step's loss, each
leaf's first gradient and each leaf's change after the last step."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matrix products in TF32 inside the block when ``tf32``, in
    full float32 otherwise."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def adam_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict[str, list], t: int, lr: float) -> None:
    b1, b2 = BETAS
    with torch.no_grad():
        for k, p in params.items():
            m, v = state.setdefault(k, [torch.zeros_like(p), torch.zeros_like(p)])
            g = grads[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** t)).sqrt() + EPS
            p.sub_(lr * (m / (1 - b1 ** t)) / denom)


def replay(params0: Dict[str, torch.Tensor], loss_fn: Callable, n_steps: int, lr: float):
    """``loss_fn(params, step)`` for steps 0..n-1 with Adam between them.
    Returns {"loss": [...], "grad1": {leaf: tensor}, "delta": {leaf: tensor}}."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    state: Dict[str, list] = {}
    losses: List[float] = []
    grad1 = {}
    for step in range(n_steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, step)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        if step == 0:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        adam_step(params, grads, state, step + 1, lr)
    delta = {k: params[k] - params0[k] for k in params}
    return {"loss": losses, "grad1": grad1, "delta": delta}
