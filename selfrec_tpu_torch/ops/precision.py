"""Compute-precision policy for the propagation hot path (counterpart of
``selfrec_tpu/ops/precision.py``).

The gathered embedding rows and the adjacency weights of the ELL products
may be cast to bfloat16, halving the gathered bytes, while kernel K2 sums
in float32. The policy is process-global, as in the JAX package: it is set
once at model build from the ``compute.dtype`` config key (``float32``
default, ``bfloat16`` opt-in, ``models/base.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

_COMPUTE_DTYPE: Optional[torch.dtype] = None

_NAMES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def set_compute_dtype(dtype) -> None:
    global _COMPUTE_DTYPE
    if isinstance(dtype, str):
        dtype = _NAMES[dtype.lower()]
    _COMPUTE_DTYPE = None if dtype == torch.float32 else dtype


def compute_dtype() -> Optional[torch.dtype]:
    """The reduced dtype for gather inputs, or None for pure f32."""
    return _COMPUTE_DTYPE
