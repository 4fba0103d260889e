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


def torch_linear_params(generator: torch.Generator, in_features: int,
                        out_features: int, *, device, dtype=torch.float32):
    """W (in, out) and b (out,) with torch.nn.Linear's default init,
    U[-1/sqrt(in), 1/sqrt(in)] for both, W drawn first (init.py:21-32). The
    reference's predictor and tower layers (BUIR.py:63, SelfCF.py:62,
    SSL4Rec.py:65-75). ``device`` has no default, as for
    :func:`xavier_uniform`."""
    bound = 1.0 / math.sqrt(in_features)
    w = torch.rand((in_features, out_features), generator=generator, device=device,
                   dtype=dtype)
    b = torch.rand((out_features,), generator=generator, device=device, dtype=dtype)
    return {"w": w * (2.0 * bound) - bound, "b": b * (2.0 * bound) - bound}


def linear_apply(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ p["w"] + p["b"]`` (init.py:35-36)."""
    return x @ p["w"] + p["b"]


def layer_params(params, name: str):
    """The {"w", "b"} of layer ``name`` in a model's flat params (dotted
    keys ``name.w``, ``name.b``; :func:`selfrec_tpu_torch.convert.flatten_params`)."""
    return {"w": params[f"{name}.w"], "b": params[f"{name}.b"]}
