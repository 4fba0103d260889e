"""Similarity/normalization helpers + top-k (a copy of
``selfrec_tpu/utils/similarity.py``).

Capability parity with the reference's legacy similarity library
(reference/util/algorithm.py:7-141: cosine/pearson/euclidean on dense
and dict-sparse vectors, min-max normalize, sigmoid) and its numba heap
``find_k_largest`` (util/algorithm.py:144-156). The shipped KNN models use
their own blocked device kernels (models/graph/userknn.py), but the reference
exposes these as public utilities so they are kept, with the same
zero-division conventions. ``find_k_largest`` here is numpy argpartition —
the device path for ranking is ops/ranking.topk_scores, not this.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np


def l1(x):
    return float(np.linalg.norm(x, ord=1))


def l2(x):
    return float(np.linalg.norm(x))


def common(x1, x2):
    overlap = (x1 != 0) & (x2 != 0)
    return x1[overlap], x2[overlap]


def cosine(x1, x2) -> float:
    total = float(np.dot(x1, x2))
    denom = math.sqrt(float(np.dot(x1, x1)) * float(np.dot(x2, x2)))
    return total / denom if denom else 0.0


def cosine_sp(x1: Dict, x2: Dict) -> float:
    total = denom1 = denom2 = 0.0
    for k, v in x1.items():
        if k in x2:
            total += v * x2[k]
            denom1 += v * v
            denom2 += x2[k] * x2[k]
    denom = math.sqrt(denom1) * math.sqrt(denom2)
    return total / denom if denom else 0.0


def pearson(x1, x2) -> float:
    new_x1 = x1 - x1.sum() / len(x1)
    new_x2 = x2 - x2.sum() / len(x2)
    total = float(np.dot(new_x1, new_x2))
    denom = math.sqrt(float(np.dot(new_x1, new_x1)) * float(np.dot(new_x2, new_x2)))
    return total / denom if denom else 0.0


def pearson_sp(x1: Dict, x2: Dict) -> float:
    if not x1 or not x2:
        return 0.0
    mean1 = sum(x1.values()) / len(x1)
    mean2 = sum(x2.values()) / len(x2)
    total = denom1 = denom2 = 0.0
    overlapped = False
    for k, v in x1.items():
        if k in x2:
            total += (v - mean1) * (x2[k] - mean2)
            denom1 += (v - mean1) ** 2
            denom2 += (x2[k] - mean2) ** 2
            overlapped = True
    denom = math.sqrt(denom1) * math.sqrt(denom2)
    if denom == 0:
        return 1.0 if overlapped else 0.0  # reference algorithm.py:80-83
    return total / denom


def euclidean(x1, x2) -> float:
    new_x1, new_x2 = common(x1, x2)
    diff = new_x1 - new_x2
    denom = math.sqrt(float(np.dot(diff, diff)))
    return 1.0 / denom if denom else 0.0


def euclidean_sp(x1: Dict, x2: Dict) -> float:
    total = sum(x1[k] ** 2 - x2[k] ** 2 for k in x1 if k in x2)
    return 1.0 / total if total else 0.0


def similarity(x1: Dict, x2: Dict, sim: str) -> float:
    if sim == "pcc":
        return pearson_sp(x1, x2)
    if sim == "euclidean":
        return euclidean_sp(x1, x2)
    return cosine_sp(x1, x2)


def normalize(vec, max_val, min_val):
    """Min-max normalization (reference algorithm.py:125-132)."""
    if max_val > min_val:
        return (vec - min_val) / (max_val - min_val)
    if max_val == min_val:
        return vec / max_val
    raise ArithmeticError("maximum value is less than minimum value.")


def denormalize(vec, max_val, min_val):
    return min_val + (vec - 0.01) * (max_val - min_val)


def sigmoid(val: float) -> float:
    return 1.0 / (1.0 + math.exp(-val))


def find_k_largest(k: int, candidates) -> Tuple[List[int], List[float]]:
    """Top-k (ids, scores) of a dense score vector, descending — same
    contract as the reference's numba heap (algorithm.py:144-156)."""
    arr = np.asarray(candidates)
    k = min(k, arr.shape[0])
    idx = np.argpartition(-arr, k - 1)[:k]
    order = idx[np.argsort(-arr[idx], kind="stable")]
    return order.tolist(), arr[order].tolist()
