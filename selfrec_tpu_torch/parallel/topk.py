"""Sharded full-rank top-k (counterpart of ``selfrec_tpu/parallel/topk.py``).

With the item axis split over ``model``, each model rank scores its item
slice, masks its slice of the rated items and takes a local top-k; ids are
offset by the slice's start. Only the ``(B, k)`` candidates of each rank
are gathered over ``model``, and a merge top-k picks the global ones. The
global top-k lies in the union of the local ones, whatever the balance of
the slices. Ties go as ``lax.top_k`` breaks them: to the lowest position,
which is the lowest slice and then the lowest id
(:func:`selfrec_tpu_torch.ops.ranking.topk_lowest_index`).
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.ops.ranking import _in_range, _mask_rated, topk_lowest_index
from selfrec_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_gather


def make_sharded_topk(mesh: Mesh, n_items: int, k: int):
    """fn(user_block (B, D), item_emb (I, D) full, mask_rows, mask_cols)
    -> (scores (B, k), ids (B, k)). ``n_items`` must divide by the model
    size (the caller keeps the unsharded eval otherwise)."""
    n_shards = mesh.shape[MODEL_AXIS]
    shard_rows = n_items // n_shards
    lo = mesh.axis_index(MODEL_AXIS) * shard_rows

    def sharded_topk(u_block, item_emb, mask_rows, mask_cols):
        item_shard = item_emb[lo: lo + shard_rows]
        scores = u_block.float() @ item_shard.float().T
        local_cols = mask_cols - lo
        in_shard = (local_cols >= 0) & (local_cols < shard_rows)
        rows = torch.where(in_shard, mask_rows, torch.full_like(mask_rows, u_block.shape[0]))
        cols = torch.where(in_shard, local_cols, torch.zeros_like(local_cols))
        scores = _mask_rated(scores, *_in_range(scores, rows, cols))
        top_s, top_i = topk_lowest_index(scores, k)
        b = u_block.shape[0]
        # (n_shards * B, k) gathered in shard order -> (B, n_shards * k)
        cand_s = all_gather(top_s, mesh, MODEL_AXIS).reshape(n_shards, b, k)
        cand_i = all_gather(top_i + lo, mesh, MODEL_AXIS).reshape(n_shards, b, k)
        cand_s = cand_s.permute(1, 0, 2).reshape(b, n_shards * k)
        cand_i = cand_i.permute(1, 0, 2).reshape(b, n_shards * k)
        top_s, pos = topk_lowest_index(cand_s, k)
        return top_s, torch.gather(cand_i, 1, pos)

    return sharded_topk
