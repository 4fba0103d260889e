"""Device selection for the port.

Every entry point takes a ``device`` argument that defaults to ``cuda``.
Asking for CUDA where there is none raises: the port never drops to the
CPU on its own, so a run that reports a device number ran on that device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``cuda``); raises when CUDA
    is requested and not available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def disable_tf32() -> None:
    """Full-precision float32 matmuls and convolutions on the card.

    TF32 keeps about three decimal digits; the f32 comparisons against the
    JAX package (``SELFREC_TPU_DENSE_DTYPE=float32``) need true f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products in full f32 (no TF32) inside the block, the
    caller's setting restored after: for products that must not depend on
    whether the caller ran :func:`disable_tf32`."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)
