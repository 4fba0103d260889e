"""Full-catalog ranking evaluation (counterpart of
``selfrec_tpu/ops/ranking.py``).

Replaces the reference's per-test-user loop (reference/base/
graph_recommender.py:38-58) with blocked device scoring: a (B x D) x (D x I)
matmul per user block, rated-item masking as a row gather from a resident
int8 incidence plus a select (the reference's -1e9 mask value,
graph_recommender.py:49), and ``torch.topk`` per block.

This slice ports the exact top-k over the dense mask. The JAX package's
knobs (ranking.py:29-72) are read: ``SELFREC_TPU_EVAL_MASK=dense`` builds
the mask past the budget as there; ``SELFREC_TPU_EVAL_MASK=scatter``, an
over-budget mask under ``auto`` (the scatter-mask eval) and
``SELFREC_TPU_EVAL_TOPK`` other than ``exact`` (the approximate top-k)
raise, naming ROADMAP.md.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

MASK_VALUE = -1e9  # reference masks rated items with -10e8


def check_eval_topk():
    """Exact top-k is all the port ranks with: ``SELFREC_TPU_EVAL_TOPK``
    other than ``exact`` (the JAX package's ``approx[:r]``,
    ranking.py:29-39, which changes the metrics) raises."""
    mode = os.environ.get("SELFREC_TPU_EVAL_TOPK", "exact")
    if mode != "exact":
        raise NotImplementedError(
            f"SELFREC_TPU_EVAL_TOPK={mode}: the approximate top-k is not ported "
            "(ROADMAP.md); unset it or set it to 'exact'")


def get_rated_dense(data, device) -> torch.Tensor:
    """Device-resident int8 rated-incidence matrix (U, I) for eval masking,
    built once from the rated CSR and cached on ``data``
    (ranking.py:42-72). ``SELFREC_TPU_EVAL_MASK``: ``auto`` (default)
    builds it within ``SELFREC_TPU_DENSE_BUDGET_GB``, ``dense`` past the
    budget; ``scatter``, and ``auto`` over the budget, raise (the
    scatter-mask eval is ROADMAP.md §1.4)."""
    from selfrec_tpu_torch.ops.spmm_dense import fits_dense

    mode = os.environ.get("SELFREC_TPU_EVAL_MASK", "auto")
    if mode == "scatter":
        raise NotImplementedError(
            "SELFREC_TPU_EVAL_MASK=scatter: the scatter-mask eval is not ported "
            "(ROADMAP.md §1.4)")
    cached = getattr(data, "_rated_dense_cache", None)
    if cached is not None and cached.device == torch.device(device):
        return cached
    if mode != "dense" and not fits_dense(data.user_num, data.item_num, torch.int8):
        raise NotImplementedError(
            f"the ({data.user_num}, {data.item_num}) rated mask exceeds "
            "SELFREC_TPU_DENSE_BUDGET_GB; the scatter-mask eval is not "
            "ported (ROADMAP.md)")
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


class EvalPlan:
    """Test users cut into fixed-size blocks (the last padded with its last
    user): ``uids_all`` (n_blocks, block_size) on ``device``. Built once per
    run and reused by every fast_evaluation."""

    def __init__(self, user_ids, block_size: int, device):
        self.block_size = block_size
        self.user_ids = np.asarray(user_ids)
        n = len(self.user_ids)
        n_blocks = -(-n // block_size)
        pad = n_blocks * block_size - n
        uids = np.concatenate(
            [self.user_ids, np.full(pad, self.user_ids[-1] if n else 0,
                                    dtype=self.user_ids.dtype)])
        self.uids_all = torch.as_tensor(
            uids.astype(np.int64).reshape(n_blocks, block_size), device=device)


def get_eval_plan(data, block_size: int, device) -> EvalPlan:
    cache = getattr(data, "_eval_plan_cache", None)
    if cache is None:
        cache = data._eval_plan_cache = {}
    key = (block_size, str(torch.device(device)))
    plan = cache.get(key)
    if plan is None:
        plan = cache[key] = EvalPlan(data.test_user_ids, block_size, device)
    return plan


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
    check_eval_topk()
    device = user_emb.device
    plan = get_eval_plan(data, block_size, device)
    rated = get_rated_dense(data, device)
    scs, idss = _topk_all_blocks_dense(user_emb.float(), item_emb.float(),
                                       plan.uids_all, rated, k)
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
                             block_size: int = 1024
                             ) -> Dict[str, List[Tuple[str, float]]]:
    """The reference-format rec_list {user_name: [(item_name, score)]} for
    all test users (ranking.py:336-356)."""
    plan, scores, ids = _ranked(data, user_emb, item_emb, k, block_size)
    return assemble_rec_list(data, plan.user_ids, ids, scores)
