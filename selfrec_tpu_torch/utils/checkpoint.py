"""Checkpoint/resume (counterpart of ``selfrec_tpu/utils/checkpoint.py``).

The reference keeps its best embeddings in process memory only
(reference/base/graph_recommender.py:91-95); the JAX package adds disk
checkpoints through orbax, and this module does the same with
``torch.save``. A checkpoint is ``<dir>/step_<N>/state.pt``: the params,
the optimizer's ``state_dict`` (Adam's moments and step count), the step
generator's state, ``aux`` and the best-tracking state (with the best
embeddings, or a sequential model's best params), every tensor on
the CPU, loadable with ``torch.load(weights_only=True)``. An orbax
checkpoint of the JAX package and one of this module are not
interchangeable.

Config surface (optional keys):
    checkpoint.dir:      directory for checkpoints (absent = disabled)
    checkpoint.interval: save every N epochs (default 5)
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch

STATE_FILE = "state.pt"
_METRIC_KEYS = ("Hit Ratio", "Precision", "Recall", "NDCG")


def _to(tree: Any, device) -> Any:
    """Every tensor of a dict/list/tuple tree moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def save_checkpoint(directory: str, step: int, state: dict) -> str:
    """Write ``state`` to ``directory/step_<N>/state.pt``, tensors on the
    CPU; the file appears whole or not at all."""
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    torch.save(_to(state, "cpu"), target + ".tmp")
    os.replace(target + ".tmp", target)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None
                       ) -> Tuple[Optional[int], Optional[dict]]:
    """The latest (or given) step's state, tensors on the CPU; (None, None)
    when there is none."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None, None
    path = os.path.join(os.path.abspath(directory), f"step_{step}", STATE_FILE)
    return step, torch.load(path, map_location="cpu", weights_only=True)


def _pack_best(model) -> dict:
    """Best-model tracking: epoch and the four metrics as one float64
    vector (epoch -1 = none yet), and the best snapshot when there is one:
    a sequential model's params, a graph model's embeddings
    (checkpoint.py:75-98)."""
    bp = model.best_performance
    vec = torch.full((1 + len(_METRIC_KEYS),), -1.0, dtype=torch.float64)
    if bp:
        vec[0] = bp[0]
        for i, k in enumerate(_METRIC_KEYS):
            vec[1 + i] = bp[1].get(k, -1.0)
    best = {"perf": vec}
    if getattr(model, "best_params", None) is not None:
        best["params"] = dict(model.best_params)
    elif getattr(model, "best_user_emb", None) is not None:
        best["user_emb"] = model.best_user_emb
        best["item_emb"] = model.best_item_emb
    return best


def _apply_best(model, best: dict) -> None:
    vec = best["perf"].tolist()
    if vec[0] >= 0:
        model.best_performance = [
            int(vec[0]), {k: vec[1 + i] for i, k in enumerate(_METRIC_KEYS)}]
        if "params" in best:
            model.best_params = _to(best["params"], model.device)
        elif "user_emb" in best:
            model.best_user_emb = best["user_emb"].to(model.device)
            model.best_item_emb = best["item_emb"].to(model.device)


def train_state(model) -> dict:
    """The resumable state of a graph or sequential recommender of the
    port (a sequential one has no aux)."""
    return {
        "params": {k: v.detach() for k, v in model.params.items()},
        "optimizer": model.optimizer.state_dict(),
        "generator": model.generator.get_state(),
        "aux": getattr(model, "aux", {}),
        "best": _pack_best(model),
    }


def apply_train_state(model, state: dict) -> None:
    """Install ``state`` into ``model``: params on ``model.device`` with a
    fresh optimizer over them in the model's key order (Adam's state maps
    to params by position), then the optimizer's state, the generator's
    (a CPU byte tensor, also for a CUDA generator), aux and best."""
    model.set_params({k: state["params"][k] for k in model.params})
    model.optimizer.load_state_dict(state["optimizer"])
    model.generator.set_state(state["generator"])
    if state["aux"]:
        model.aux = _to(state["aux"], model.device)
    _apply_best(model, state["best"])
