"""Weights between the two packages.

The JAX package keeps a model's parameters as a pytree: a dict of arrays,
with nested dicts and lists for layers (BUIR's ``predictor`` {w, b},
SSL4Rec's ``user_tower`` [{w, b}, {w, b}]). This port keeps a flat dict of
tensors whose keys are the tree's paths joined with dots (``predictor.w``,
``user_tower.0.b``), so Adam and the checkpoint see one flat dict in a fixed
key order. Passing through numpy lets both packages start from the same
weights (the tests do so) without this package importing JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from selfrec_tpu_torch.device import resolve_device


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts and lists -> {dotted path: leaf}, in the tree's order:
    {"predictor": {"w": W}} -> {"predictor.w": W}, {"tower": [{"b": b}]} ->
    {"tower.0.b": b}. A flat dict comes back as it is."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(flatten_params(v, f"{prefix}.{k}" if prefix else str(k)))
    return flat


def _lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def unflatten_params(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`flatten_params`: a path segment of digits
    names a list position."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return _lists(tree)


def params_from_jax(params: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """A JAX params tree of arrays (after ``np.asarray`` of each leaf) ->
    {dotted name: tensor} on ``device`` (default the card, like every
    entry point; pass ``device="cpu"`` for the CPU), values and dtypes
    unchanged."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, copy=True), device=dev)
            for k, v in flatten_params(params).items()}


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{dotted name: tensor} -> the JAX package's tree of numpy arrays,
    ready for ``jnp.asarray`` leaf by leaf."""
    return unflatten_params({k: v.detach().cpu().numpy().copy() for k, v in params.items()})
