"""Training objectives (counterpart of ``selfrec_tpu/ops/losses.py``, every
loss of it, those no model calls included).

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


def triplet_loss(user_emb, pos_item_emb, neg_item_emb, margin: float = 0.5, mask=None):
    """relu(|u - p|^2 - |u - n|^2 + margin), the squared-distance triplet
    (losses.py:46-51; reference loss_torch.py:12-16)."""
    pos_score = torch.sum((user_emb - pos_item_emb) ** 2, dim=-1)
    neg_score = torch.sum((user_emb - neg_item_emb) ** 2, dim=-1)
    return _masked_mean(torch.relu(pos_score - neg_score + margin), mask)


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


def info_nce_recbole(z_i, z_j, temp: float, batch_size: int, sim: str = "dot"):
    """RecBole's 2N-view InfoNCE (losses.py:99-121; reference
    loss_torch.py:54-88): each of the 2N rows has its other view as the
    positive and the other 2(N-1) rows as negatives, the positive
    prepended as class 0 of a cross-entropy."""
    n = 2 * batch_size
    z = torch.cat([z_i, z_j], dim=0)
    if sim == "cos":
        zn = l2_normalize(z)
        sim_mat = zn @ zn.T / temp
    else:
        sim_mat = z @ z.T / temp
    pos = torch.cat([torch.diagonal(sim_mat, offset=batch_size),
                     torch.diagonal(sim_mat, offset=-batch_size)])
    idx = torch.arange(n, device=z.device)
    self_mask = idx[:, None] == idx[None, :]
    pair_mask = ((idx[:, None] == idx[None, :] + batch_size)
                 | (idx[:, None] + batch_size == idx[None, :]))
    neg_logits = torch.where(self_mask | pair_mask, torch.full_like(sim_mat, -1e9), sim_mat)
    logits = torch.cat([pos[:, None], neg_logits], dim=1)
    return -torch.mean(F.log_softmax(logits, dim=1)[:, 0])


def kl_divergence(p_logit, q_logit):
    """KL(softmax(p) || softmax(q)) per row, averaged (losses.py:124-131;
    reference loss_torch.py:91-94)."""
    p = torch.softmax(p_logit, dim=-1)
    kl = torch.sum(p * (F.log_softmax(p_logit, dim=-1) - F.log_softmax(q_logit, dim=-1)),
                   dim=1)
    return torch.mean(kl)


def ssm_loss(user_emb, pos_item_emb, neg_item_emb, mask=None):
    """Sampled softmax over explicit negatives at tau 0.2 (losses.py:198-212;
    reference util/loss_tf.py:19-29): every embedding l2-normalised, the
    positive prepended to the negative columns of the denominator."""
    user_emb = l2_normalize(user_emb)
    pos_item_emb = l2_normalize(pos_item_emb)
    neg_item_emb = l2_normalize(neg_item_emb)
    pos_score = torch.sum(user_emb * pos_item_emb, dim=1)
    ttl = user_emb @ neg_item_emb.T
    if mask is not None:
        ttl = torch.where(mask.to(torch.bool)[None, :], ttl, torch.full_like(ttl, -1e9))
    ttl = torch.cat([pos_score[:, None], ttl], dim=1)
    pos_e = torch.exp(pos_score / 0.2)
    ttl_e = torch.sum(torch.exp(ttl / 0.2), dim=1)
    return -_masked_mean(torch.log(pos_e / ttl_e), mask)


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
