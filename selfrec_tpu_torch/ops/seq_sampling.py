"""Sequence batch ops on the device: negative sampling and the
CL4SRec/BERT4Rec augmentations (counterpart of
``selfrec_tpu/ops/seq_sampling.py``).

torch's draws cannot replay ``jax.random``, so each op is a draw from a
``torch.Generator`` followed by a deterministic function of that draw.
Every op takes its draw fed (``u=`` / ``draws=``) or draws it from
``generator`` when none is given; fed JAX draws give JAX's outputs
exactly (the tests replay them in JAX's key order). The deterministic
parts follow seq_sampling.py line for line; ranks use stable sorts, as
``jnp.argsort`` is stable, so tied keys (the ``inf`` lanes past a row's
length) rank by position.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample_seq_negatives(generator: Optional[torch.Generator], seq: torch.Tensor,
                         item_num: int, n_rounds: int = 4,
                         draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-position negatives in [1, item_num], redrawn for
    ``n_rounds - 1`` rounds where the candidate is in the row's window; 0 at
    pad positions (seq_sampling.py:28-48). seq: (B, L) with 0 = pad.
    ``draws``: the (n_rounds, B, L) candidates, uniform in [1, item_num]:
    round 0 the first draw (:37), round r >= 1 round r's replacements
    (JAX's ``fold_in(keys[-1], r)``, :43-44)."""
    if draws is None:
        draws = torch.randint(1, item_num + 1, (n_rounds, *seq.shape), generator=generator,
                              device=seq.device)
    draws = draws.to(seq.dtype)
    neg = draws[0]
    for r in range(1, n_rounds):
        in_window = torch.any(neg[:, :, None] == seq[:, None, :], dim=-1)
        neg = torch.where(in_window, draws[r], neg)
    return torch.where(seq != 0, neg, torch.zeros_like(neg))


def _uniform(generator, shape, device, u):
    if u is not None:
        return u.to(device=device, dtype=torch.float32)
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def _rand_starts(u: torch.Tensor, seq_len: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """start = trunc(u * max(len - span, 1)) in f32 (seq_sampling.py:51-56):
    uniform over 0..len - span - 1."""
    hi = torch.clamp(seq_len - span, min=1).to(torch.float32)
    return (u * hi).to(torch.int32)


def _span(seq_len: torch.Tensor, ratio: float) -> torch.Tensor:
    """floor(len * ratio) in f32, as int32 (``jnp.floor(seq_len * r)``)."""
    return torch.floor(seq_len.to(torch.float32) * ratio).to(torch.int32)


def item_crop(generator, seq, seq_len, crop_ratio,
              u=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Contiguous crop of floor(len*ratio)+1 items from a uniform start,
    new positions 1..crop_len (seq_sampling.py:59-72). ``u``: the (B,)
    uniform of the start. Returns (aug_seq, aug_pos, aug_len)."""
    b, l = seq.shape
    span = _span(seq_len, crop_ratio)
    crop_len = span + 1
    start = _rand_starts(_uniform(generator, (b,), seq.device, u), seq_len, span)
    ar = torch.arange(l, device=seq.device)
    idx = torch.clamp(ar[None, :] + start[:, None], 0, l - 1).long()
    gathered = torch.gather(seq, 1, idx)
    keep = ar[None, :] < crop_len[:, None]
    aug_seq = torch.where(keep, gathered, torch.zeros_like(gathered))
    aug_pos = torch.where(keep, (ar + 1).to(seq.dtype)[None, :], torch.zeros_like(gathered))
    return aug_seq, aug_pos, crop_len


def item_reorder(generator, seq, seq_len, reorder_ratio, u=None) -> torch.Tensor:
    """Shuffle a random span of floor(len*ratio)+1 items in place
    (seq_sampling.py:75-88). ``u``: (u_start (B,), u_perm (B, L)), JAX's
    two draws after ``split(key)``."""
    b, l = seq.shape
    u_start, u_perm = (None, None) if u is None else u
    span = _span(seq_len, reorder_ratio)
    start = _rand_starts(_uniform(generator, (b,), seq.device, u_start), seq_len, span)
    posn = torch.arange(l, device=seq.device, dtype=torch.float32)[None, :]
    in_span = (posn >= start[:, None]) & (posn <= (start + span)[:, None])
    up = _uniform(generator, (b, l), seq.device, u_perm)
    # composite sort key: random rank inside the span, identity outside
    sort_key = torch.where(
        in_span, start[:, None].to(torch.float32)
        + up * (span[:, None] + 1).to(torch.float32), posn.expand(b, l))
    order = torch.argsort(sort_key, dim=1, stable=True)
    return torch.gather(seq, 1, order)


def _pick_k_positions(u, seq_len, k_counts):
    """(B, L) mask with exactly k_counts[b] distinct positions among
    [0, seq_len[b]) (seq_sampling.py:91-97): positions past the length get
    ``inf``, then the rank of each position is argsort of argsort."""
    l = u.shape[1]
    ar = torch.arange(l, device=u.device)
    u = torch.where(ar[None, :] < seq_len[:, None], u, torch.full_like(u, float("inf")))
    rank = torch.argsort(torch.argsort(u, dim=1, stable=True), dim=1, stable=True)
    return rank < k_counts[:, None]


def item_mask(generator, seq, seq_len, mask_ratio, mask_idx, u=None) -> torch.Tensor:
    """Replace floor(len*ratio) random positions with the mask token
    (seq_sampling.py:100-105). ``u``: the (B, L) uniforms."""
    k = _span(seq_len, mask_ratio)
    chosen = _pick_k_positions(_uniform(generator, seq.shape, seq.device, u), seq_len, k)
    return torch.where(chosen, torch.full_like(seq, mask_idx), seq)


def bert_mask(generator, seq, seq_len, mask_ratio, mask_idx, u=None):
    """BERT4Rec's masking (seq_sampling.py:108-113): max(floor(len*ratio), 1)
    positions; returns (aug_seq, chosen)."""
    k = torch.clamp(_span(seq_len, mask_ratio), min=1)
    chosen = _pick_k_positions(_uniform(generator, seq.shape, seq.device, u), seq_len, k)
    return torch.where(chosen, torch.full_like(seq, mask_idx), seq), chosen
