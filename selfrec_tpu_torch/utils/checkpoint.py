"""Checkpoint/resume (counterpart of ``selfrec_tpu/utils/checkpoint.py``).

The reference keeps its best embeddings in process memory only
(reference/base/graph_recommender.py:91-95); the JAX package adds disk
checkpoints through orbax, and this module does the same with
``torch.save``. A checkpoint is ``<dir>/step_<N>/state.pt``: the params,
the optimizer's ``state_dict`` (Adam's moments and step count; on the card
a capturable Adam's, whose step count is a device tensor), the step
generator's state, ``aux`` and the best-tracking state (with the best
embeddings, or a sequential model's best params), every tensor on
the CPU, loadable with ``torch.load(weights_only=True)``. An orbax
checkpoint of the JAX package and one of this module are not
interchangeable.

Under a mesh the file holds the same full state: every rank gathers its
row blocks of the params, of Adam's moments and of a sequential model's
best params over ``model``, rank 0 writes, and on resume every rank reads
the file and keeps its own rows (checkpoint.py's orbax restore of the
row-sharded tables, tests/test_checkpoint.py:81-109).

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
        best["params"] = model.gather_leaves(dict(model.best_params))
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
            model.best_params = model.shard_leaves(_to(best["params"], model.device))
        elif "user_emb" in best:
            model.best_user_emb = best["user_emb"].to(model.device)
            model.best_item_emb = best["item_emb"].to(model.device)


def _optimizer_state(model, convert) -> dict:
    """The optimizer's state_dict with each param's moments passed through
    ``convert`` (Adam's state maps to params by position)."""
    sd = model.optimizer.state_dict()
    keys = list(model.params)
    return dict(sd, state={i: convert(dict(st), [keys[i]] * len(st))
                           for i, st in sd["state"].items()})


def train_state(model) -> dict:
    """The resumable state of a graph or sequential recommender of the
    port (a sequential one has no aux), full under a mesh too."""
    return {
        "params": model.gather_leaves({k: v.detach() for k, v in model.params.items()}),
        "optimizer": _optimizer_state(model, model.gather_leaves),
        "generator": model.generator.get_state(),
        "aux": getattr(model, "aux", {}),
        "best": _pack_best(model),
    }


def apply_train_state(model, state: dict) -> None:
    """Install ``state`` into ``model``: params on ``model.device`` (this
    rank's rows under a mesh) with a fresh optimizer over them in the
    model's key order (Adam's state maps to params by position), then the
    optimizer's state, the generator's (a CPU byte tensor, also for a CUDA
    generator), aux and best. Once a step graph holds the params and
    Adam's state, both are written in place (``set_params``,
    ``load_optimizer_state``), and so is an aux with the live aux's keys
    (``write_aux``). Adam's state
    of a checkpoint written before the port's steps were graphed (a
    non-capturable Adam, its step count on the CPU) loads into the
    capturable Adam of the card."""
    model.set_params({k: state["params"][k] for k in model.params})
    keys = list(model.params)
    model.load_optimizer_state({
        i: model.shard_leaves(dict(st), [keys[i]] * len(st))
        for i, st in state["optimizer"]["state"].items()})
    model.generator.set_state(state["generator"])
    if state["aux"]:
        aux = _to(state["aux"], model.device)
        if set(aux) == set(model.aux):
            model.write_aux(aux)
        else:
            model.aux = aux  # other keys: a new aux, which a step graph captures again
    _apply_best(model, state["best"])
