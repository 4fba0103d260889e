"""Weighted ELL gather plus sorted segment-sum: kernel K2 of the port.

    partial[v, p*D + d] = sum_k w[p, v, k] * x[vidx[v, k], p*D + d]
    out[r]              = sum of partial[v] over the virtual rows v of r

over one row-split ELL layout (:class:`selfrec_tpu_torch.ops.spmm_ell.
EllLayout`) for P passes of width D packed side by side in ``x``. Replaces
the Pallas kernel ``selfrec_tpu/ops/spmm_pallas.py`` (``_spmm_kernel``
:62-75, ``_pallas_partial`` :79-111, ``PallasEll.apply`` :135-142). The JAX
package never dispatches that kernel (spmm_pallas.py:26-32): its ELL path
computes the same function with an XLA gather, an einsum and a
``segment_sum`` (spmm_ell.py:133-189, 286-297). The port computes it
through K2, so the sums differ from the JAX package's only in f32 order.

On the card it is the hand-written CUDA kernel in ``csrc/ell_gather.cu``
(two phases: per-virtual-row partials, then an in-order sum over each
row's contiguous partials; no atomics, so runs repeat bit for bit); that
file states its design and its bound on an H100.

:func:`ell_gather_sum` takes :func:`ell_gather_sum_plain` only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
``ell_gather_sum.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from selfrec_tpu_torch.ops import cuda_build

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build("ell_gather.cu"))
            lib.selfrec_ell_gather_sum.restype = ctypes.c_int
            lib.selfrec_ell_gather_sum.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            _lib = lib
    return _lib


def ell_gather_sum_plain(layout, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch, in the same two phases: the
    (V, P*D) f32 partials by a gather and an einsum, then their sum into
    each virtual row's destination (``index_add_`` over ``vdst``)."""
    p, v, k = w.shape
    c = x.shape[1]
    g = x[layout.vidx].reshape(v, k, p, c // p).to(torch.float32)
    partial = torch.einsum("pvk,vkpd->vpd", w, g).reshape(v, c)
    out = torch.zeros((layout.n_rows, c), dtype=torch.float32, device=x.device)
    return out.index_add_(0, layout.vdst, partial)


def _check(layout, w, x):
    if w.dtype != torch.float32 or w.dim() != 3:
        raise TypeError(f"ell_gather_sum takes f32 weights (P, V, K), got "
                        f"{w.dtype} {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"ell_gather_sum takes f32 or bf16 rows (n, P*D), got "
                        f"{x.dtype} {tuple(x.shape)}")
    p, v, k = w.shape
    if (v, k) != (layout.vdst.shape[0], layout.k) or layout.vidx.shape[0] != v * k:
        raise ValueError(f"weights {tuple(w.shape)} do not fit the layout "
                         f"(V={layout.vdst.shape[0]}, K={layout.k})")
    if x.shape[1] % p:
        raise ValueError(f"width {x.shape[1]} is not {p} passes of equal width")
    if x.shape[0] < layout.n_src:
        raise ValueError(f"the layout gathers from {layout.n_src} rows, x has "
                         f"{x.shape[0]}")
    tensors = (layout.vidx, layout.vdst, layout.row_ptr, w, x)
    if any(t.device != x.device for t in tensors):
        raise ValueError("ell_gather_sum operands lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ell_gather_sum needs contiguous operands")


def ell_gather_sum(layout, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(n_rows, P*D) f32 propagation of ``x`` (n, P*D), f32 or bf16, over
    ``layout`` with per-pass weights ``w`` (P, V, K) f32.

    CPU tensors take :func:`ell_gather_sum_plain`. CUDA tensors launch the
    Hopper kernel (sm_90a) or raise."""
    _check(layout, w, x)
    if x.device.type == "cpu":
        return ell_gather_sum_plain(layout, w, x)
    if x.device.type != "cuda":
        raise RuntimeError(f"ell_gather_sum: no kernel for device {x.device}")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError("ell_gather_sum's kernel is built for sm_90a (Hopper); "
                           f"device {x.device} is sm_"
                           "%d%d" % torch.cuda.get_device_capability(x.device))
    p, v, k = w.shape
    c = x.shape[1]
    if (c // p) % 4:
        raise ValueError(f"ell_gather_sum's kernel needs a pass width that is a "
                         f"multiple of 4, got {c // p}")
    lib = _load()
    if x.data_ptr() % (4 * x.element_size()):
        raise ValueError("ell_gather_sum needs x aligned to 4 elements")
    partial = torch.empty((v, c), dtype=torch.float32, device=x.device)
    out = torch.empty((layout.n_rows, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.selfrec_ell_gather_sum(
            layout.vidx.data_ptr(), w.data_ptr(), x.data_ptr(),
            int(x.dtype == torch.bfloat16), layout.row_ptr.data_ptr(),
            partial.data_ptr(), out.data_ptr(), v, k, layout.n_rows, p, c // p,
            stream)
    if rc != 0:
        raise RuntimeError(f"ell_gather_sum kernel launch failed: CUDA error {rc}")
    ell_gather_sum.launches += 1
    return out


ell_gather_sum.launches = 0
