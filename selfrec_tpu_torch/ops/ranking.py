"""Full-catalog ranking evaluation (counterpart of
``selfrec_tpu/ops/ranking.py``).

Replaces the reference's per-test-user loop (reference/base/
graph_recommender.py:38-58) with blocked device scoring: a (B x D) x (D x I)
matmul per user block, rated-item masking with the reference's -1e9 mask
value (graph_recommender.py:49), and a top-k per block.

The rated items are masked by one of two means, as in the JAX package
(ranking.py:42-72, 260-318): a row gather from a resident int8 (U, I)
incidence plus a select (``SELFREC_TPU_EVAL_MASK=auto`` within
``SELFREC_TPU_DENSE_BUDGET_GB``, or ``dense``), or a scatter of the rated
(row, item) pairs that :class:`EvalPlan` holds per block (``scatter``, and
``auto`` over the budget). The JAX package's scatter drops the padded lanes
(row ``block_size``) by its out-of-bounds mode; torch has none, so the port
scatters only a block's real lanes, which the plan counts once.

Two top-k orders: score-function ranking (:func:`rec_list_from_score_fn`,
:func:`topk_scores`, :func:`topk_scores_masked`,
:func:`topk_scores_unmasked`; KNN's scores tie by construction) breaks ties
by the lowest index, as ``lax.top_k`` does (:func:`topk_lowest_index`);
the embedding evals (:func:`topk_ids_from_embeddings`,
:func:`rec_list_from_embeddings`) keep ``torch.topk``, whose tie order is
unspecified, since continuous embedding scores do not tie in practice.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MASK_VALUE = -1e9  # reference masks rated items with -10e8


def eval_topk_recall() -> Optional[float]:
    """``SELFREC_TPU_EVAL_TOPK`` (ranking.py:29-39): ``exact`` (default)
    gives None; ``approx`` or ``approx:r`` give the recall target r
    (default 0.95) that the JAX package passes to ``lax.approx_max_k``.
    That is approximate only on a TPU and returns ``lax.top_k``'s ids
    elsewhere, so the port ranks exactly for it too; any other value
    raises."""
    mode = os.environ.get("SELFREC_TPU_EVAL_TOPK", "exact")
    if mode.startswith("approx"):
        return float(mode.split(":", 1)[1]) if ":" in mode else 0.95
    if mode != "exact":
        raise NotImplementedError(
            f"SELFREC_TPU_EVAL_TOPK={mode}: the port ranks with 'exact' or "
            "'approx[:r]' (ROADMAP.md)")
    return None


def topk_lowest_index(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` of each row of f32 ``scores``, descending, ties broken by
    the lowest index: ``lax.top_k``'s order, which ``torch.topk`` does not
    promise. Each (value, index) pair becomes one int64 key, the value's
    bits mapped to a signed integer of the same total order (-0.0 below
    +0.0, as XLA's top-k compares) in the high word and the complement of
    the index in the low word; keys are distinct, so ``torch.topk`` over
    them has one answer. Returns (values, ids)."""
    bits = scores.float().contiguous().view(torch.int32).to(torch.int64)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.arange(scores.shape[-1], device=scores.device, dtype=torch.int64)
    key = (order << 32) | (0xFFFFFFFF - idx)
    top = torch.topk(key, k, dim=-1).values
    ids = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    return torch.gather(scores, -1, ids), ids


def get_rated_dense(data, device) -> Optional[torch.Tensor]:
    """Device-resident int8 rated-incidence matrix (U, I) for eval masking,
    built once from the rated CSR and cached on ``data``
    (ranking.py:42-72). ``SELFREC_TPU_EVAL_MASK``: ``auto`` (default)
    builds it within ``SELFREC_TPU_DENSE_BUDGET_GB``, ``dense`` past the
    budget. Returns None, and the caller masks by the plan's scatter, for
    ``scatter`` and for ``auto`` over the budget."""
    from selfrec_tpu_torch.ops.spmm_dense import fits_dense

    mode = os.environ.get("SELFREC_TPU_EVAL_MASK", "auto")
    if mode == "scatter":
        return None
    cached = getattr(data, "_rated_dense_cache", None)
    if cached is not None and cached.device == torch.device(device):
        return cached
    if mode != "dense" and not fits_dense(data.user_num, data.item_num, torch.int8):
        return None
    counts = np.diff(np.asarray(data.rated_offsets))
    rows = torch.as_tensor(np.repeat(np.arange(data.user_num, dtype=np.int64),
                                     counts), device=device)
    cols = torch.as_tensor(np.asarray(data.rated_items, dtype=np.int64),
                           device=device)
    m = torch.zeros((data.user_num, data.item_num), dtype=torch.int8,
                    device=device)
    m[rows, cols] = 1
    data._rated_dense_cache = m
    return m


def _mask_rated(scores: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """``scores[rows, cols] = MASK_VALUE`` over in-range (row, item) pairs."""
    scores[rows, cols] = MASK_VALUE
    return scores


def _in_range(scores: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """The lanes that ``.at[rows, cols].set(..., mode="drop")`` would write:
    both indices inside ``scores``; the others are dropped, never indexed."""
    rows, cols = rows.long(), cols.long()
    keep = (rows >= 0) & (rows < scores.shape[0]) & (cols >= 0) & (cols < scores.shape[1])
    return rows[keep], cols[keep]


def topk_scores(user_emb, item_emb, mask_rows, mask_cols, k: int):
    """Top-k over the full catalog for one user block (ranking.py:75-92):
    f32 scores, the rated (row-in-block, item) pairs masked (padded lanes
    out of range are dropped), ties by the lowest index. Returns (scores,
    ids), each (B, k), descending."""
    scores = user_emb.float() @ item_emb.float().T
    return topk_scores_masked(scores, mask_rows, mask_cols, k)


def topk_scores_unmasked(scores: torch.Tensor, k: int):
    return topk_lowest_index(scores, k)


def topk_scores_masked(scores: torch.Tensor, mask_rows, mask_cols, k: int):
    """Top-k over precomputed scores with rated-pair masking
    (ranking.py:100-106); writes the mask into ``scores``."""
    return topk_lowest_index(_mask_rated(scores, *_in_range(scores, mask_rows, mask_cols)), k)


def names_array(id2name: Dict[int, str], size: int) -> np.ndarray:
    """Dense numpy object array of names for bulk id->name translation."""
    arr = np.empty(size, dtype=object)
    for i, name in id2name.items():
        arr[i] = name
    return arr


def _cached_names(data, attr: str, id2name: Dict[int, str], size: int):
    arr = getattr(data, attr, None)
    if arr is None or len(arr) != size:
        arr = names_array(id2name, size)
        setattr(data, attr, arr)
    return arr


def assemble_rec_list(data, user_ids: np.ndarray, top_ids: np.ndarray,
                      top_scores: np.ndarray) -> Dict[str, List[Tuple[str, float]]]:
    """Bulk-build {user_name: [(item_name, score), ...]} from stacked top-k
    results (ranking.py:125-143)."""
    user_names = _cached_names(data, "_user_names_arr", data.id2user,
                               data.user_num)
    item_names = _cached_names(data, "_item_names_arr", data.id2item,
                               data.item_num)
    uname_list = user_names[np.asarray(user_ids)].tolist()
    name_rows = item_names[top_ids].tolist()
    score_rows = np.asarray(top_scores, dtype=np.float64).tolist()
    return {
        u: list(zip(names, scores))
        for u, names, scores in zip(uname_list, name_rows, score_rows)
    }


def csr_pairs(offsets: np.ndarray, cols: np.ndarray, ids: np.ndarray):
    """The (row, col) pairs of the CSR rows ``ids`` (``offsets``, ``cols``),
    row r being ``ids[r]``'s entries in CSR order; host numpy."""
    starts = np.asarray(offsets)[ids].astype(np.int64)
    counts = np.asarray(offsets)[np.asarray(ids) + 1].astype(np.int64) - starts
    rows = np.repeat(np.arange(len(ids), dtype=np.int32), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return rows, np.asarray(cols)[np.repeat(starts, counts) + np.arange(len(rows)) - first]


class EvalPlan:
    """Per-block padded uids, rated-mask rows/cols and valid count for the
    batched full-rank eval (ranking.py:161-204), built once per run and
    reused by every eval. Test users are cut into ``block_size`` blocks,
    the last padded with its last user. Each block's rated (row-in-block,
    item) pairs of its valid users are padded to the largest block's count
    with row ``block_size`` and item 0, the JAX package's arrays; the
    device copies, ``blocks`` ((uids, rows, cols, valid) a block) and the
    stacked ``uids_all``, ``rows_all``, ``cols_all``, sit on ``device``.
    ``n_rated[b]`` counts block b's real lanes, which lead its rows: the
    ``rows < block_size`` filter, built once, through which the port's
    scatter skips the padded lanes."""

    def __init__(self, user_ids, rated_offsets, rated_items, block_size: int, device):
        self.block_size = block_size
        self.user_ids = np.asarray(user_ids)
        rated_offsets = np.asarray(rated_offsets)
        rated_items = np.asarray(rated_items)
        n = len(self.user_ids)
        n_blocks = -(-n // block_size)
        counts = np.diff(rated_offsets)[self.user_ids].astype(np.int64)
        self.n_rated = [int(counts[b * block_size:(b + 1) * block_size].sum())
                        for b in range(n_blocks)]
        pad_nnz = max([1] + self.n_rated)
        uids_np, rows_np, cols_np = [], [], []
        for b in range(n_blocks):
            lo, hi = b * block_size, min((b + 1) * block_size, n)
            uids = self.user_ids[lo:hi]
            valid = len(uids)
            uids = np.concatenate([uids, np.full(block_size - valid, uids[-1],
                                                 dtype=uids.dtype)])
            rows, cols = csr_pairs(rated_offsets, rated_items, uids[:valid])
            pad = pad_nnz - len(rows)
            uids_np.append(uids)
            rows_np.append(np.concatenate([rows, np.full(pad, block_size, np.int32)]))
            cols_np.append(np.concatenate([cols.astype(np.int32), np.zeros(pad, np.int32)]))
        as_dev = lambda a: torch.as_tensor(np.stack(a).astype(np.int64), device=device)
        if n_blocks:
            self.uids_all, self.rows_all, self.cols_all = map(as_dev, (uids_np, rows_np,
                                                                       cols_np))
        else:
            empty = torch.zeros((0, block_size), dtype=torch.int64, device=device)
            self.uids_all, self.rows_all, self.cols_all = empty, empty, empty
        self.blocks = [(self.uids_all[b], self.rows_all[b], self.cols_all[b],
                        min(block_size, n - b * block_size)) for b in range(n_blocks)]


def get_eval_plan(data, block_size: int, device) -> EvalPlan:
    cache = getattr(data, "_eval_plan_cache", None)
    if cache is None:
        cache = data._eval_plan_cache = {}
    key = (block_size, str(torch.device(device)))
    plan = cache.get(key)
    if plan is None:
        plan = cache[key] = EvalPlan(data.test_user_ids, data.rated_offsets,
                                     data.rated_items, block_size, device)
    return plan


def rec_list_from_score_fn(data, score_block_fn, k: int, block_size: int = 1024,
                           device=None) -> Dict[str, List[Tuple[str, float]]]:
    """The rec_list of a model without embedding tables (KNN,
    ranking.py:146-158): ``score_block_fn(uids)`` scores one block of
    padded test users (a (block_size,) int64 tensor on ``device``) against
    every item; the plan's rated pairs are masked and the top-k taken with
    ties by the lowest index."""
    device = torch.device("cpu" if device is None else device)
    plan = get_eval_plan(data, block_size, device)
    ids_blocks, score_blocks = [], []
    for (uids, rows, cols, valid), n in zip(plan.blocks, plan.n_rated):
        scores = _mask_rated(score_block_fn(uids), rows[:n], cols[:n])
        top_scores, top_ids = topk_lowest_index(scores, k)
        ids_blocks.append(top_ids[:valid].cpu().numpy())
        score_blocks.append(top_scores[:valid].cpu().numpy())
    return assemble_rec_list(data, plan.user_ids, np.concatenate(ids_blocks),
                             np.concatenate(score_blocks))


def batched_full_rank(user_ids, get_user_block, item_emb, rated_offsets, rated_items,
                      k: int, block_size: int = 1024, plan: EvalPlan = None,
                      topk_impl=None):
    """Host loop over user blocks (ranking.py:219-251), yielding
    (user_id, top item ids, top scores) in input order.
    ``get_user_block(uids)`` maps a block's padded ids to its user
    embeddings; ``topk_impl(u_emb, item_emb, rows, cols) -> (scores, ids)``
    replaces :func:`topk_scores`, whose padded mask lanes are dropped."""
    if plan is None:
        plan = EvalPlan(user_ids, rated_offsets, rated_items, block_size, item_emb.device)
    for b, (uids, rows, cols, valid) in enumerate(plan.blocks):
        u_emb = get_user_block(uids)
        if topk_impl is not None:
            top_scores, top_ids = topk_impl(u_emb, item_emb, rows, cols)
        else:
            top_scores, top_ids = topk_scores(u_emb, item_emb, rows, cols, k)
        top_scores = top_scores.cpu().numpy()
        top_ids = top_ids.cpu().numpy()
        for r in range(valid):
            yield plan.user_ids[b * plan.block_size + r], top_ids[r], top_scores[r]


def _topk_all_blocks(user_emb, item_emb, plan: EvalPlan, k: int):
    """Every eval block with the scatter mask (ranking.py:260-287): scores,
    the block's real rated lanes set to -1e9, ``torch.topk``. Returns
    (scores, ids), each (n_blocks, B, k); the same top-k as
    :func:`_topk_all_blocks_dense`, so both masks give equal ids."""
    scs, idss = [], []
    item_t = item_emb.T
    for uids, rows, cols, n in zip(plan.uids_all, plan.rows_all, plan.cols_all,
                                   plan.n_rated):
        scores = _mask_rated(user_emb[uids] @ item_t, rows[:n], cols[:n])
        top_scores, top_ids = torch.topk(scores, k, dim=1)
        scs.append(top_scores)
        idss.append(top_ids)
    return torch.stack(scs), torch.stack(idss)


def _topk_all_blocks_dense(user_emb, item_emb, uids_all, rated, k: int):
    """Every eval block: scores, rated-item mask from the resident incidence
    (exactly the reference's set-to--1e9 semantics), top-k
    (ranking.py:290-306). Returns (scores, ids), each (n_blocks, B, k)."""
    scs, idss = [], []
    item_t = item_emb.T
    for uids in uids_all:
        scores = user_emb[uids] @ item_t
        scores = torch.where(rated[uids] != 0,
                             torch.full_like(scores, MASK_VALUE), scores)
        top_scores, top_ids = torch.topk(scores, k, dim=1)
        scs.append(top_scores)
        idss.append(top_ids)
    return torch.stack(scs), torch.stack(idss)


@torch.no_grad()
def _ranked(data, user_emb, item_emb, k: int, block_size: int):
    """The ``auto`` dispatch (ranking.py:309-318): the dense-mask scan when
    :func:`get_rated_dense` gives the incidence, else the scatter scan."""
    eval_topk_recall()
    device = user_emb.device
    plan = get_eval_plan(data, block_size, device)
    rated = get_rated_dense(data, device)
    ue, ie = user_emb.float(), item_emb.float()
    if rated is not None:
        scs, idss = _topk_all_blocks_dense(ue, ie, plan.uids_all, rated, k)
    else:
        scs, idss = _topk_all_blocks(ue, ie, plan, k)
    n = len(plan.user_ids)
    return (plan, scs.reshape(-1, k)[:n].cpu().numpy(),
            idss.reshape(-1, k)[:n].cpu().numpy())


def topk_ids_from_embeddings(data, user_emb, item_emb, k: int,
                             block_size: int = 1024) -> np.ndarray:
    """(n_test_users, k) top item ids (internal), rows in test-user order —
    the raw-array path of per-epoch fast_evaluation (ranking.py:321-333)."""
    _, _, ids = _ranked(data, user_emb, item_emb, k, block_size)
    return ids


def rec_list_from_embeddings(data, user_emb, item_emb, k: int,
                             block_size: int = 1024, topk_impl=None
                             ) -> Dict[str, List[Tuple[str, float]]]:
    """The reference-format rec_list {user_name: [(item_name, score)]} for
    all test users (ranking.py:336-368). ``topk_impl(u_emb, item_emb,
    rows, cols) -> (scores, ids)`` (the sharded top-k,
    :mod:`selfrec_tpu_torch.parallel.topk`) takes each block of the plan in
    place of the all-blocks scan."""
    if topk_impl is None:
        plan, scores, ids = _ranked(data, user_emb, item_emb, k, block_size)
        return assemble_rec_list(data, plan.user_ids, ids, scores)
    with torch.no_grad():
        plan = get_eval_plan(data, block_size, user_emb.device)
        ids_blocks, score_blocks = [], []
        for uids, rows, cols, valid in plan.blocks:
            top_scores, top_ids = topk_impl(user_emb[uids], item_emb, rows, cols)
            ids_blocks.append(top_ids[:valid].cpu().numpy())
            score_blocks.append(top_scores[:valid].cpu().numpy())
    return assemble_rec_list(data, plan.user_ids, np.concatenate(ids_blocks),
                             np.concatenate(score_blocks))
