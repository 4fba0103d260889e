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


def params_from_jax(params: Dict[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """{name: array} (a flat JAX params dict after ``np.asarray``) ->
    {name: tensor} on ``device``, values and dtypes unchanged."""
    return {k: torch.as_tensor(np.array(v, copy=True), device=device)
            for k, v in params.items()}


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{name: tensor} -> {name: numpy array}, ready for ``jnp.asarray``."""
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
