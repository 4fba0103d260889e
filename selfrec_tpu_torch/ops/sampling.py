"""On-device negative sampling and epoch batching (counterpart of
``selfrec_tpu/ops/sampling.py``).

Replaces the reference's host rejection loop (reference/util/
sampler.py:23-27) with a vectorised sampler: draw uniform candidates, test
membership in the user's rated set, redraw colliding lanes for a fixed
number of rounds. Membership is a probe of a packed per-user bitmap
(:func:`sample_negatives_bitmap`) or, where the bitmap is over its budget,
one ``torch.searchsorted`` a round over the rated pairs' sorted keys
``user * n_items + item`` (:func:`sample_negatives`, :func:`rated_keys`).
The JAX package searches each user's segment of the rated CSR step by
step instead (:func:`searchsorted_in_segments`, kept as its counterpart):
the same membership, but a dozen steps of small kernels a round, whose
launch gaps made a captured step's time on the card vary from capture to
capture by 5%. Both samplers draw the same numbers in the same order from
a ``torch.Generator``, so for one generator state they return the same
negatives; the numbers differ from the JAX package's, the rejection
semantics are the same.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch


def bitmap_fits(n_users: int, n_items: int) -> bool:
    """Whether the (U, ceil(I/32)) uint32 rated bitmap fits
    ``SELFREC_TPU_NEG_BITMAP_MB`` (default 512; base.py:453-471): the gate
    between the bitmap sampler and the CSR one."""
    budget_mb = float(os.environ.get("SELFREC_TPU_NEG_BITMAP_MB", "512"))
    return n_users * ((n_items + 31) // 32) * 4 <= budget_mb * 1e6


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


def searchsorted_in_segments(flat_sorted: torch.Tensor, offsets: torch.Tensor,
                             seg_ids: torch.Tensor, values: torch.Tensor,
                             n_search_steps: int) -> torch.Tensor:
    """Vectorised membership test (sampling.py:23-49): ``values[k]`` in
    ``flat_sorted[offsets[s]:offsets[s + 1]]`` with ``s = seg_ids[k]``.
    A binary search of ``n_search_steps`` >= ceil(log2(longest segment +
    1)) steps, ``mid`` clamped into the array, and a hit counted only
    where the search stayed inside its segment (``lo < hi0``), so empty
    segments find nothing."""
    size = flat_sorted.shape[0]
    if size == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    seg_ids = seg_ids.long()
    lo = offsets[seg_ids].long()
    hi = offsets[seg_ids + 1].long()
    hi0 = hi
    for _ in range(n_search_steps):
        mid = (lo + hi) >> 1
        go_right = flat_sorted[mid.clamp(0, size - 1)] < values
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    return (lo < hi0) & (flat_sorted[lo.clamp(0, size - 1)] == values)


def _rejection_rounds(generator, users, n_items, n_rounds, is_rated):
    """``cand`` uniform over the catalog, then ``n_rounds`` rounds each
    drawing one ``fresh`` candidate a lane and taking it where ``cand`` is
    rated: the draw order both samplers share."""
    dev = users.device
    cand = torch.randint(0, n_items, users.shape, generator=generator,
                         device=dev, dtype=torch.int64)
    for _ in range(n_rounds):
        bad = is_rated(cand)
        fresh = torch.randint(0, n_items, users.shape, generator=generator,
                              device=dev, dtype=torch.int64)
        cand = torch.where(bad, fresh, cand)
    return cand


def _lanes(user_idx: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    users = user_idx.reshape(-1).to(torch.int64)
    if len(shape) == 2:
        users = torch.repeat_interleave(users, shape[1])
    return users


def rated_keys(rated_offsets: torch.Tensor, rated_items: torch.Tensor,
               n_items: int) -> torch.Tensor:
    """(nnz,) int64 keys ``user * n_items + item`` of the rated CSR, in its
    order, which is sorted: its rows are the users in order and each row's
    items ascend."""
    counts = rated_offsets[1:] - rated_offsets[:-1]
    users = torch.repeat_interleave(
        torch.arange(counts.numel(), device=rated_items.device), counts,
        output_size=rated_items.numel())
    return users * n_items + rated_items.to(torch.int64)


def sample_negatives(generator: torch.Generator, user_idx: torch.Tensor,
                     rated_keys: torch.Tensor, n_items: int, shape: Tuple[int, ...],
                     n_rounds: int = 8) -> torch.Tensor:
    """Uniform negatives for each (user, slot) in ``shape`` = (B,) or
    (B, n_negs), a lane's candidate rated where its key ``user * n_items +
    item`` is among ``rated_keys`` (:func:`rated_keys`; sampling.py:52-83
    searches the CSR's segments instead): the sampler for a rated bitmap
    over ``SELFREC_TPU_NEG_BITMAP_MB``. Draws as
    :func:`sample_negatives_bitmap` does, so the two return the same
    negatives for one generator state."""
    users = _lanes(user_idx, shape)
    if rated_keys.numel() == 0:
        is_rated = lambda c: torch.zeros(c.shape, dtype=torch.bool, device=c.device)
    else:
        row = users * n_items
        last = rated_keys.numel() - 1

        def is_rated(c):
            q = row + c
            return rated_keys[torch.searchsorted(rated_keys, q).clamp_(max=last)] == q

    return _rejection_rounds(generator, users, n_items, n_rounds, is_rated).reshape(shape)


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
    users = _lanes(user_idx, shape)
    cand = _rejection_rounds(
        generator, users, n_items, n_rounds,
        lambda c: ((rated_bitmap[users, c >> 5] >> (c & 31)) & 1) != 0)
    return cand.reshape(shape)


def unique_with_mask(idx: torch.Tensor, size: int):
    """Deduplicate a 1D index array into a static-size buffer.

    Returns (padded unique ids, validity mask) exactly as
    ``jnp.unique(idx, size=size, fill_value=-1)`` followed by
    sampling.py:194-196: sorted distinct values (a ``-1`` in ``idx`` counts
    as a value), ``-1`` fill past them, invalid slots mapped to 0. Matches
    the reference's ``torch.unique`` anchors (SimGCL.py:44-45).

    Static shapes, no device-to-host sync (a train step runs it inside a
    CUDA graph): sort, flag the first of each run, number the runs with a
    cumulative sum, and scatter each run's value into a ``size``-long
    buffer of ``-1``; runs numbered ``size`` or more, and every repeat,
    land in one extra slot that is cut off."""
    uniq = torch.full((size + 1,), -1, dtype=idx.dtype, device=idx.device)
    if idx.numel():
        s = torch.sort(idx.reshape(-1)).values
        first = torch.ones_like(s, dtype=torch.bool)
        first[1:] = s[1:] != s[:-1]
        slot = torch.cumsum(first, 0) - 1
        uniq.scatter_(0, torch.where(first & (slot < size), slot, size), s)
    uniq = uniq[:size]
    mask = uniq >= 0
    return torch.where(mask, uniq, torch.zeros_like(uniq)), mask


def epoch_pointwise_batches(rng, edge_users, edge_items, n_items: int,
                            batch_size: int, n_negs: int = 4):
    """Pointwise epoch batches (sampling.py:199-238; reference
    util/sampler.py:31-55, which no shipped model calls): each shuffled
    positive labelled 1 followed by ``n_negs`` uniform items labelled 0,
    cut into (n_batches, batch_size) users, items, labels and a validity
    mask. Identical to the JAX package's for one numpy generator."""
    n = len(edge_users)
    perm = rng.permutation(n)
    group = 1 + n_negs
    users = np.repeat(edge_users[perm], group)
    items = np.empty(n * group, dtype=np.int32)
    items[::group] = edge_items[perm]
    labels = np.zeros(n * group, dtype=np.float32)
    labels[::group] = 1.0
    for k in range(1, group):
        items[k::group] = rng.integers(0, n_items, n, dtype=np.int32)
    total = n * group
    n_batches = -(-total // batch_size)
    pad = n_batches * batch_size - total
    users = np.concatenate([users, np.zeros(pad, np.int32)])
    items = np.concatenate([items, np.zeros(pad, np.int32)])
    labels = np.concatenate([labels, np.zeros(pad, np.float32)])
    mask = np.concatenate([np.ones(total, np.float32), np.zeros(pad, np.float32)])
    shape = (n_batches, batch_size)
    return (users.reshape(shape), items.reshape(shape), labels.reshape(shape),
            mask.reshape(shape))


def epoch_pairwise_batches(rng, edge_users, edge_items, batch_size: int):
    """Host-side epoch batching: shuffle the edge list once per epoch and cut
    into fixed-size batches (last batch padded, with a validity mask).
    Identical to sampling.py:241-271 (reference util/sampler.py:5-18); the
    trainer's path under ``SELFREC_TPU_HOST_BATCHES=1``."""
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
