"""Training objectives (the part of ``selfrec_tpu/ops/losses.py:19-96`` that
SimGCL needs; the remaining losses come with their models).

Every loss takes an optional ``mask`` so fixed-shape padded batches reduce
over valid rows only; with a full batch the results match the reference
conventions (including the ``10e-6 = 1e-5`` epsilon inside the BPR log,
reference/util/loss_torch.py:9).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    mask = mask.to(x.dtype)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x * rsqrt(max(sum(x^2), eps^2)): the value of F.normalize, with a
    finite gradient at exactly-zero rows (see selfrec_tpu/ops/losses.py)."""
    s = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(s, min=eps * eps))


def bpr_loss(user_emb, pos_item_emb, neg_item_emb, mask=None):
    """-log(sigmoid(pos - neg) + 1e-5). Reference loss_torch.py:6-10."""
    pos_score = torch.sum(user_emb * pos_item_emb, dim=-1)
    neg_score = torch.sum(user_emb * neg_item_emb, dim=-1)
    loss = -torch.log(1e-5 + torch.sigmoid(pos_score - neg_score))
    return _masked_mean(loss, mask)


def l2_reg_loss(reg: float, *embs, mask=None):
    """reg * sum_e ||E_e||_F / rows(E_e). Reference loss_torch.py:18-22."""
    total = 0.0
    for emb in embs:
        if mask is not None:
            m = mask.to(emb.dtype).reshape(-1, *([1] * (emb.dim() - 1)))
            emb = emb * m
            rows = torch.clamp(torch.sum(mask.to(emb.dtype)), min=1.0)
        else:
            rows = emb.shape[0]
        total = total + torch.sqrt(torch.sum(emb * emb) + 1e-24) / rows
    return total * reg


def infonce(view1, view2, temperature: float, b_cos: bool = True, mask=None):
    """-mean(diag(log_softmax(V1 V2ᵀ / τ))). Reference loss_torch.py:35-50.

    ``mask`` marks valid rows of both views; invalid rows are excluded as
    anchors AND as in-batch negatives.
    """
    if b_cos:
        view1 = l2_normalize(view1)
        view2 = l2_normalize(view2)
    logits = view1 @ view2.T / temperature
    if mask is not None:
        logits = torch.where(mask.to(torch.bool)[None, :], logits,
                             torch.full_like(logits, -1e9))
    log_probs = F.log_softmax(logits, dim=1)
    diag = torch.diagonal(log_probs)
    return -_masked_mean(diag, mask)
