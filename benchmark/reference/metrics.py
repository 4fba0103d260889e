"""SELFRec's ranking metrics (util/evaluation.py), in plain numpy.

Hit ratio counts hit interactions over all test interactions; precision
divides hits by users times N; recall averages each user's hits over their
test items; NDCG takes the ideal DCG over the user's first N test items in
the order they were listed. Every value is rounded to 5 decimals, as
SELFRec rounds inside each metric."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def ranking_metrics(truth: List[List[int]], recs: List[List[int]], n: int) -> Dict[str, float]:
    """``truth[u]``: user u's test items in listed order; ``recs[u]``: the
    recommended items, best first (possibly fewer than n)."""
    if len(truth) != len(recs):
        raise ValueError(f"{len(truth)} test users against {len(recs)} lists")
    hits, recall, ndcg = 0, 0.0, 0.0
    total = sum(len(t) for t in truth)
    for t, r in zip(truth, recs):
        ts = set(t)
        top = r[:n]
        h = sum(1 for x in set(top) if x in ts)
        hits += h
        recall += h / len(t)
        dcg = sum(1.0 / np.log2(rank + 2) for rank, x in enumerate(top) if x in ts)
        idcg = sum(1.0 / np.log2(rank + 2) for rank in range(min(len(t), n)))
        ndcg += dcg / idcg
    users = len(truth)
    return {"Hit Ratio": round(hits / total, 5),
            "Precision": round(hits / (users * n), 5),
            "Recall": round(recall / users, 5),
            "NDCG": round(ndcg / users, 5)}
