"""What both trainer families read of the program's state after the check
steps."""

from __future__ import annotations

from typing import Dict

import torch


def first_gradient_norms(optimizer, params: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's first gradient as Adam got it, worked out from its first
    moment after one step (``(1 - beta1) * g``); 0 where Adam holds no
    state for the leaf (no step reached it)."""
    b1 = optimizer.defaults["betas"][0]
    out = {}
    for k, p in params.items():
        m = optimizer.state.get(p, {}).get("exp_avg")
        out[k] = 0.0 if m is None else float(torch.linalg.norm(m.double())) / (1 - b1)
    return out


def change_norms(params: Dict[str, torch.Tensor], params0: Dict[str, torch.Tensor]):
    """Each leaf's change from ``params0``, by its norm."""
    with torch.no_grad():
        return {k: float(torch.linalg.norm((params[k] - params0[k]).double())) for k in params}


def k1_launches() -> int:
    """K1's launches so far, float and int8, replays included."""
    from selfrec_tpu_torch.ops import dense_dual

    return dense_dual.float_products.launches + dense_dual.dual_matmul.launches
