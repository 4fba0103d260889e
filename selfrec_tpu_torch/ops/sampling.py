"""On-device negative sampling and epoch batching (counterpart of
``selfrec_tpu/ops/sampling.py:86-300``).

Replaces the reference's host rejection loop (reference/util/
sampler.py:23-27) with a vectorised sampler: draw uniform candidates, test
membership in a packed per-user bitmap, redraw colliding lanes for a fixed
number of rounds. Draws come from a ``torch.Generator``, so the numbers
differ from the JAX package's; the rejection semantics are the same.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def pack_rated_bitmap(rated_offsets, rated_items, n_users: int, n_items: int):
    """Host-side one-time pack of the per-user rated-item sets into a
    (U, ceil(I/32)) uint32 bitmap (identical to sampling.py:86-106)."""
    words = (n_items + 31) // 32
    bm = np.zeros((n_users, words), np.uint32)
    items = np.asarray(rated_items)
    rows = np.repeat(np.arange(n_users), np.diff(np.asarray(rated_offsets)))
    np.bitwise_or.at(
        bm, (rows, items >> 5),
        (np.uint32(1) << (items & 31).astype(np.uint32)))
    return bm


def bitmap_to_device(bitmap: np.ndarray, device) -> torch.Tensor:
    """The uint32 bitmap as an int32 device tensor (same bits): torch's
    bitwise shifts are defined for int32."""
    return torch.as_tensor(bitmap.view(np.int32), device=device)


def sample_negatives_bitmap(generator: torch.Generator, user_idx: torch.Tensor,
                            rated_bitmap: torch.Tensor, n_items: int,
                            shape: Tuple[int, ...],
                            n_rounds: int = 8) -> torch.Tensor:
    """Uniform negatives for each (user, slot) in ``shape`` = (B,) or
    (B, n_negs), redrawing lanes that hit a rated item for ``n_rounds``
    rounds (residual collision probability p^(n_rounds+1) per lane, as in
    sampling.py:110-184).

    The JAX package compacts the failing lanes for very wide lane counts, a
    TPU gather optimisation whose semantics equal the dense loop's; this
    port runs the dense loop at every width."""
    users = user_idx.reshape(-1).to(torch.int64)
    if len(shape) == 2:
        users = torch.repeat_interleave(users, shape[1])
    dev = users.device
    cand = torch.randint(0, n_items, users.shape, generator=generator,
                         device=dev, dtype=torch.int64)
    for _ in range(n_rounds):
        word = rated_bitmap[users, cand >> 5]
        bad = ((word >> (cand & 31)) & 1) != 0
        fresh = torch.randint(0, n_items, users.shape, generator=generator,
                              device=dev, dtype=torch.int64)
        cand = torch.where(bad, fresh, cand)
    return cand.reshape(shape)


def unique_with_mask(idx: torch.Tensor, size: int):
    """Deduplicate a 1D index array into a static-size buffer.

    Returns (padded unique ids, validity mask) exactly as
    ``jnp.unique(idx, size=size, fill_value=-1)`` followed by
    sampling.py:194-196: sorted distinct values (a ``-1`` in ``idx`` counts
    as a value), ``-1`` fill past them, invalid slots mapped to 0. Matches
    the reference's ``torch.unique`` anchors (SimGCL.py:44-45)."""
    uniq = torch.unique(idx)[:size]
    fill = torch.full((size - uniq.numel(),), -1, dtype=idx.dtype,
                      device=idx.device)
    uniq = torch.cat([uniq, fill])
    mask = uniq >= 0
    return torch.where(mask, uniq, torch.zeros_like(uniq)), mask


def epoch_pairwise_batches(rng, edge_users, edge_items, batch_size: int):
    """Host-side epoch batching: shuffle the edge list once per epoch and cut
    into fixed-size batches (last batch padded, with a validity mask).
    Identical to sampling.py:241-271 (reference util/sampler.py:5-18)."""
    n = len(edge_users)
    perm = rng.permutation(n)
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    users = np.concatenate([edge_users[perm], np.zeros(pad, dtype=np.int32)])
    items = np.concatenate([edge_items[perm], np.zeros(pad, dtype=np.int32)])
    mask = np.concatenate(
        [np.ones(n, dtype=np.float32), np.zeros(pad, dtype=np.float32)])
    return (users.reshape(n_batches, batch_size),
            items.reshape(n_batches, batch_size),
            mask.reshape(n_batches, batch_size))


def epoch_pairwise_batches_device(generator: torch.Generator,
                                  edge_users: torch.Tensor,
                                  edge_items: torch.Tensor, batch_size: int):
    """Device twin of :func:`epoch_pairwise_batches`: a uniform permutation
    of the resident edge arrays and a fixed-size batch reshape, entirely on
    the edges' device (sampling.py:274-300)."""
    n = edge_users.shape[0]
    dev = edge_users.device
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    perm = torch.randperm(n, generator=generator, device=dev)
    zeros = torch.zeros(pad, dtype=torch.int64, device=dev)
    users = torch.cat([edge_users.to(torch.int64)[perm], zeros])
    items = torch.cat([edge_items.to(torch.int64)[perm], zeros])
    mask = torch.cat([torch.ones(n, dtype=torch.float32, device=dev),
                      torch.zeros(pad, dtype=torch.float32, device=dev)])
    return (users.reshape(n_batches, batch_size),
            items.reshape(n_batches, batch_size),
            mask.reshape(n_batches, batch_size))
