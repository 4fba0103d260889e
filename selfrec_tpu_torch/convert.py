"""Weights between the two packages.

The JAX package keeps a model's parameters as a pytree of arrays; this port
keeps a plain dict of tensors with the same keys. Passing through numpy lets
both packages start from the same weights (the tests do so) without this
package importing JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from selfrec_tpu_torch.device import resolve_device


def params_from_jax(params: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """{name: array} (a flat JAX params dict after ``np.asarray``) ->
    {name: tensor} on ``device`` (default the card, like every entry point;
    pass ``device="cpu"`` for the CPU), values and dtypes unchanged."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, copy=True), device=dev)
            for k, v in params.items()}


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{name: tensor} -> {name: numpy array}, ready for ``jnp.asarray``."""
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
