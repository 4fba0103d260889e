"""Ranking metrics with exact reference conventions.

Parity notes (each quirk reproduced deliberately — see SURVEY.md §2 #24):
- ``hit_ratio`` is (# hit interactions) / (# all test interactions), NOT a
  per-user rate (reference/util/evaluation.py:18-30).
- ``NDCG`` computes IDCG over the first N test items in INSERTION order, not
  sorted relevance (reference/util/evaluation.py:85-97).
- every metric is rounded to 5 decimals before aggregation, as the reference
  rounds inside each metric function.
- ``ranking_evaluation`` output is the same list-of-strings format the
  reference writes to its performance files (util/evaluation.py:135-162).

Both ranking evaluations are the ``metrics.ids`` span
(:mod:`selfrec_tpu_torch.utils.trace`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from selfrec_tpu_torch.utils import trace

RecList = Dict[str, List[Tuple[str, float]]]
Origin = Dict[str, Dict[str, float]]


def hits(origin: Origin, res: RecList) -> Dict[str, int]:
    hit_count = {}
    for user in origin:
        items = set(origin[user].keys())
        predicted = {item[0] for item in res[user]}
        hit_count[user] = len(items & predicted)
    return hit_count


def hit_ratio(origin: Origin, hit_counts: Dict[str, int]) -> float:
    total_num = sum(len(origin[user]) for user in origin)
    hit_num = sum(hit_counts.values())
    return round(hit_num / total_num, 5)


def precision(hit_counts: Dict[str, int], n: int) -> float:
    prec = sum(hit_counts.values())
    return round(prec / (len(hit_counts) * n), 5)


def recall(hit_counts: Dict[str, int], origin: Origin) -> float:
    recall_list = [hit_counts[user] / len(origin[user]) for user in hit_counts]
    return round(sum(recall_list) / len(recall_list), 5)


def f1(prec: float, rec: float) -> float:
    if (prec + rec) != 0:
        return round(2 * prec * rec / (prec + rec), 5)
    return 0


def ndcg(origin: Origin, res: RecList, n: int) -> float:
    sum_ndcg = 0.0
    for user in res:
        dcg = 0.0
        idcg = 0.0
        user_origin = origin[user]
        for rank, item in enumerate(res[user]):
            if item[0] in user_origin:
                dcg += 1.0 / math.log2(rank + 2)
        # IDCG over the first n test items in insertion order (reference quirk)
        for rank, _item in enumerate(list(user_origin.keys())[:n]):
            idcg += 1.0 / math.log2(rank + 2)
        sum_ndcg += dcg / idcg
    return round(sum_ndcg / len(res), 5)


def mae(res: Sequence[Tuple]) -> float:
    if not res:
        return 0
    error = sum(abs(entry[2] - entry[3]) for entry in res)
    return round(error / len(res), 5)


def rmse(res: Sequence[Tuple]) -> float:
    if not res:
        return 0
    error = sum((entry[2] - entry[3]) ** 2 for entry in res)
    return round(math.sqrt(error / len(res)), 5)


@trace.span("metrics.ids")
def ranking_evaluation(origin: Origin, res: RecList, top_ns: Sequence[int]) -> List[str]:
    measure: List[str] = []
    if len(origin) != len(res):
        raise ValueError(
            f"The lengths of test set ({len(origin)}) and predicted set ({len(res)}) do not match!"
        )
    for n in top_ns:
        predicted = {user: res[user][:n] for user in res}
        hit_counts = hits(origin, predicted)
        indicators = [
            "Hit Ratio:" + str(hit_ratio(origin, hit_counts)) + "\n",
            "Precision:" + str(precision(hit_counts, n)) + "\n",
            "Recall:" + str(recall(hit_counts, origin)) + "\n",
            "NDCG:" + str(ndcg(origin, predicted, n)) + "\n",
        ]
        measure.append("Top " + str(n) + "\n")
        measure += indicators
    return measure


@trace.span("metrics.ids")
def ranking_evaluation_ids(
    test_offsets, test_items, top_ids, top_ns: Sequence[int], hit_mask,
) -> List[str]:
    """Vectorized ``ranking_evaluation`` over internal integer ids.

    Produces the SAME strings (same formulas, same 5-decimal rounding,
    same reference quirks — interaction-level hit ratio, insertion-order
    IDCG) without building the {user_name: [(item_name, score)]} dict, which
    costs ~0.9s of host time per eval at 30k+ test users. Inputs:
    ``test_offsets``/``test_items`` — CSR of each test user's ground-truth
    item ids in INSERTION order, rows in the same user order as
    ``top_ids`` (n_users, K), of which the metrics read the counts;
    ``hit_mask`` — (n_users, K) bool, true where ``top_ids`` holds a
    ground-truth item of its row, as the ranking tested it
    (``ranking.topk_ids_from_embeddings``'s ``hits_out``). Equal strings
    to the JAX package's and the string path's: tests/test_torch_eval.py.
    """
    import numpy as np

    test_offsets = np.asarray(test_offsets, dtype=np.int64)
    top_ids = np.asarray(top_ids, dtype=np.int64)
    n_users, K = top_ids.shape
    if n_users != len(test_offsets) - 1:
        raise ValueError(
            f"The lengths of test set ({len(test_offsets) - 1}) and "
            f"predicted set ({n_users}) do not match!"
        )
    len_u = np.diff(test_offsets)
    if len(len_u) and int(len_u.min()) <= 0:
        # the reference's per-user recall/NDCG divide by the ground-truth
        # count and raise ZeroDivisionError on a degenerate user
        # (util/evaluation.py recall/NDCG) — fail loudly like it does
        # instead of propagating NaN into the measure strings
        raise ZeroDivisionError(
            "test user with zero ground-truth items in ranking_evaluation_ids")
    total_num = int(len_u.sum())
    hit_mask = np.asarray(hit_mask, dtype=bool)
    if hit_mask.shape != top_ids.shape:
        raise ValueError(f"hit mask {hit_mask.shape} is not the shape of the top "
                         f"ids {top_ids.shape}")

    w = 1.0 / np.log2(np.arange(K, dtype=np.float64) + 2.0)
    cum_w = np.concatenate([[0.0], np.cumsum(w)])
    # the hits alone (a few per user at most): each row's in rank order, so
    # a user's DCG is summed best rank first, as the string path sums it
    hit_row, hit_rank = np.divmod(np.flatnonzero(hit_mask), K)

    measure: List[str] = []
    for n in top_ns:
        keep = hit_rank < n
        hits_u = np.bincount(hit_row[keep], minlength=n_users)
        hit_num = int(hits_u.sum())
        hr = round(hit_num / total_num, 5)
        prec = round(hit_num / (n_users * n), 5)
        rec = round(float(np.mean(hits_u / len_u)), 5)
        dcg = np.bincount(hit_row[keep], weights=w[hit_rank[keep]], minlength=n_users)
        idcg = cum_w[np.minimum(len_u, n)]
        nd = round(float(np.sum(dcg / idcg) / n_users), 5)
        measure.append("Top " + str(n) + "\n")
        measure += [
            "Hit Ratio:" + str(hr) + "\n",
            "Precision:" + str(prec) + "\n",
            "Recall:" + str(rec) + "\n",
            "NDCG:" + str(nd) + "\n",
        ]
    return measure


def rating_evaluation(res: Sequence[Tuple]) -> List[str]:
    return ["MAE:" + str(mae(res)) + "\n", "RMSE:" + str(rmse(res)) + "\n"]


def parse_measure(measure: List[str]) -> Dict[str, float]:
    """Parse ranking_evaluation output lines into {metric: value}."""
    performance = {}
    for m in measure[1:]:
        if ":" in m:
            k, v = m.strip().split(":")
            performance[k] = float(v)
    return performance
