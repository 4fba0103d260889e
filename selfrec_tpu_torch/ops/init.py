"""Parameter initialisers matching the reference's torch defaults.

Counterpart of ``selfrec_tpu/ops/init.py``; draws come from a
``torch.Generator`` instead of a ``jax.random`` key, so the numbers
differ from the JAX package's for the same seed (tests hand both
packages the same weights through :mod:`selfrec_tpu_torch.convert`)."""

from __future__ import annotations

import math

import torch


def xavier_uniform(generator: torch.Generator, shape, *, device,
                   dtype=torch.float32, gain: float = 1.0) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ semantics: for a 2D (rows, cols) tensor
    fan_in=cols, fan_out=rows, bound = gain*sqrt(6/(fan_in+fan_out)).
    Every reference model initialises its embedding tables this way
    (e.g. reference/model/graph/MF.py:52-57). ``device`` has no default:
    the tables land where the caller says, never on the CPU by omission."""
    fan_out, fan_in = shape[0], shape[-1]
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return u * (2.0 * bound) - bound
