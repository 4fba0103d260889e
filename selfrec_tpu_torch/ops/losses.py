"""Training objectives (the part of ``selfrec_tpu/ops/losses.py:19-195`` that
the ported models need; the remaining losses come with their models).

Every loss takes an optional ``mask`` so fixed-shape padded batches reduce
over valid rows only; with a full batch the results match the reference
conventions (including the ``10e-6 = 1e-5`` epsilon inside the BPR log,
reference/util/loss_torch.py:9).
"""

from __future__ import annotations

import math
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


def l2_loss(x: torch.Tensor) -> torch.Tensor:
    """0.5 * sum(x^2): ``tf.nn.l2_loss``, the social models' regularizer."""
    return 0.5 * torch.sum(x * x)


def bpr_loss_sum(user_emb, pos_item_emb, neg_item_emb, mask=None):
    """BPR summed, not averaged, with the ``10e-8`` inside the log
    (losses.py:215-224; reference util/loss_tf.py:4-7): the social models'
    (MHCN, SEPT) rec loss."""
    pos_score = torch.sum(user_emb * pos_item_emb, dim=-1)
    neg_score = torch.sum(user_emb * neg_item_emb, dim=-1)
    loss = -torch.log(torch.sigmoid(pos_score - neg_score) + 10e-8)
    if mask is not None:
        loss = loss * mask.to(loss.dtype)
    return torch.sum(loss)


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


def batch_softmax_loss(user_emb, item_emb, temperature: float, mask=None):
    """In-batch sampled softmax retrieval loss (losses.py:69-79; reference
    loss_torch.py:25-32): -log(exp(cos(u, i)/τ) / Σ_j exp(cos(u, j)/τ) +
    1e-5), the denominator over the batch's valid items only."""
    user_emb = l2_normalize(user_emb)
    item_emb = l2_normalize(item_emb)
    pos_score = torch.exp(torch.sum(user_emb * item_emb, dim=-1) / temperature)
    ttl = torch.exp(user_emb @ item_emb.T / temperature)
    if mask is not None:
        ttl = ttl * mask.to(ttl.dtype)[None, :]
    ttl_score = torch.sum(ttl, dim=1)
    loss = -torch.log(pos_score / ttl_score + 1e-5)
    return _masked_mean(loss, mask)


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


def alignment_loss_masked(x, y, mask=None):
    """DirectAU alignment over valid rows: mean ||x^ - y^||^2 of the
    l2-normalised pairs (losses.py:134-137)."""
    x, y = l2_normalize(x), l2_normalize(y)
    return _masked_mean(torch.sum((x - y) ** 2, dim=-1), mask)


def _strict_upper(n: int, device=None) -> torch.Tensor:
    """(n, n) boolean i<j mask (losses.py:140-150): the pair matrix stays a
    masked full-matrix reduction, not a triangle gather."""
    r = torch.arange(n, device=device)
    return r[:, None] < r[None, :]


def _pair_d2(x: torch.Tensor) -> torch.Tensor:
    """Squared distances of the l2-normalised rows, (n, n)."""
    x = l2_normalize(x)
    sq = torch.sum(x * x, dim=-1)
    return sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)


def uniformity_loss(x, t: int = 2):
    """DirectAU uniformity: log E exp(-t ||xi-xj||^2) over the strict i<j
    pairs of ``torch.pdist`` (reference DirectAU.py:42-45; losses.py:153-165)."""
    d2 = _pair_d2(x)
    n = x.shape[0]
    logits = torch.where(_strict_upper(n, x.device), -t * d2,
                         torch.full_like(d2, -float("inf")))
    return torch.logsumexp(logits.reshape(-1), dim=0) - math.log(n * (n - 1) // 2)


def uniformity_loss_masked(x, mask, t: int = 2):
    """Uniformity over the strict i<j pairs of valid (non-pad) rows only
    (losses.py:168-195): the reference's exact-size ``torch.pdist`` with
    one static shape. Fewer than 2 valid rows give no pair: the JAX package
    returns 0 with a zero gradient there (PARITY.md; the reference's
    logsumexp over nothing is -inf and poisons its backward), and so does
    this, through the same double ``where``: the all-invalid branch reduces
    over every pair, so no -inf reaches the backward."""
    d2 = _pair_d2(x)
    n = x.shape[0]
    m = mask.to(x.dtype)
    pair_valid = _strict_upper(n, x.device) & (m[:, None] * m[None, :] > 0)
    n_pairs = torch.sum(pair_valid.to(x.dtype))
    has_pairs = n_pairs > 0
    safe_valid = torch.where(has_pairs, pair_valid, torch.ones_like(pair_valid))
    logits = torch.where(safe_valid, -t * d2, torch.full_like(d2, -float("inf")))
    lse = torch.logsumexp(logits.reshape(-1), dim=0) - torch.log(
        torch.clamp(n_pairs, min=1.0))
    return torch.where(has_pairs, lse, torch.zeros_like(lse))
