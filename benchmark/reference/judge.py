"""The numbers that decide ``correct``, each worked out from the program's
answers and the reference's.

Training (the first steps that set-up drives through the window's own
call): the widest relative gap of a step's loss; and, by the worst leaf,
the gap between the norms of the program's and the reference's first
gradient, and of their change of the parameters after the last step, over
the larger of that leaf's reference norm and the median leaf's. Leaves
whose reference gradient is under a thousandth of the median leaf's move
by round-off alone and are left out of both.

Ranking (what the window's last eval returned): the widest gap by which
the reference's score of the program's item at a rank lies below the
reference's best score at that rank, over the median of the reference's
best scores; the rows whose ids repeat, leave the catalog or name an
excluded item; and the largest difference of a reported metric from
SELFRec's arithmetic over the program's own lists."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.metrics import ranking_metrics

EXCLUDE_BELOW = 1e-3  # of the median leaf's first-gradient norm


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in tree.items()}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``: {"loss": [...], "grad1": {leaf: norm}, "delta": {leaf: norm}};
    ``ref``: :func:`benchmark.reference.train.replay`'s tensors."""
    g_ref, d_ref = _norms(ref["grad1"]), _norms(ref["delta"])
    g_med = float(np.median(list(g_ref.values())))
    d_med = float(np.median(list(d_ref.values())))
    leaves = [k for k, v in g_ref.items() if v >= EXCLUDE_BELOW * g_med]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"]))
    grad_gap = max(abs(prog["grad1"][k] - g_ref[k]) / max(g_ref[k], g_med) for k in leaves)
    delta_gap = max(abs(prog["delta"][k] - d_ref[k]) / max(d_ref[k], d_med) for k in leaves)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "delta_gap": delta_gap}


def reference_train_answers(ref: dict) -> dict:
    """The reference's readings in the program's form, for a control or a
    fault planted in the reference put in the program's place."""
    return {"loss": list(ref["loss"]), "grad1": _norms(ref["grad1"]),
            "delta": _norms(ref["delta"])}


def rank_numbers(scorer, ids: np.ndarray, block: int = 1024) -> Dict[str, float]:
    """``ids``: the program's (rows, k) top ids, rows in the scorer's order."""
    device = scorer.item_emb.device
    gaps, best0, bad = [], [], 0
    for lo in range(0, ids.shape[0], block):
        s = scorer.scores(lo, lo + block).float()
        got_ids = torch.as_tensor(ids[lo:lo + block], dtype=torch.int64, device=device)
        best = torch.topk(s, scorer.k, dim=1).values
        n = s.shape[1]
        in_range = ((got_ids >= 0) & (got_ids < n)).all(dim=1)
        got = torch.gather(s, 1, got_ids.clamp(0, n - 1))
        srt = torch.sort(got_ids, dim=1).values
        repeated = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
        bad += int((~in_range | repeated | torch.isinf(got).any(dim=1)).sum())
        ok = torch.isfinite(got)
        gaps.append(torch.where(ok, best - got, torch.zeros_like(got)).amax(dim=1))
        best0.append(best[:, 0].abs())
    scale = float(torch.median(torch.cat(best0)))
    return {"rank_gap": float(torch.cat(gaps).max()) / max(scale, 1e-30), "rank_bad": bad}


def metric_gap(reported: Dict[str, float], truth: List[List[int]], recs: List[List[int]],
               n: int) -> float:
    """The largest difference of a reported metric from SELFRec's
    arithmetic over the same lists; a metric missing reads infinite."""
    want = ranking_metrics(truth, recs, n)
    return max(abs(reported[k] - v) if k in reported else float("inf")
               for k, v in want.items())


def parse_measure(measure: List[str]) -> Dict[str, float]:
    """SELFRec's measure lines (``"Recall:0.0123\\n"``) as numbers."""
    out = {}
    for line in measure:
        if ":" in line:
            k, v = line.strip().split(":", 1)
            out[k] = float(v)
    return out


def decide(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, list]:
    """{name: [number, limit]} for every limit; a number missing or not
    finite fails it."""
    return {k: [numbers.get(k, float("inf")), lim] for k, lim in limits.items()}


def passed(checks: Dict[str, list]) -> bool:
    return all(np.isfinite(v) and v <= lim for v, lim in checks.values())
