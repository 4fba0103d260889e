"""Weighted ELL gather plus sorted segment-sum: kernel K2 of the port.

    out[r, p*D + d] = sum over the virtual rows v of r, and k < K, of
                      w[p, v, k] * x[vidx[v, k], p*D + d]

over one row-split ELL layout (:class:`selfrec_tpu_torch.ops.spmm_ell.
EllLayout`) for P passes of width D packed side by side in ``x``. Replaces
the Pallas kernel ``selfrec_tpu/ops/spmm_pallas.py`` (``_spmm_kernel``
:62-75, ``_pallas_partial`` :79-111, ``PallasEll.apply`` :135-142). The JAX
package never dispatches that kernel (spmm_pallas.py:26-32): its ELL path
computes the same function with an XLA gather, an einsum and a
``segment_sum`` (spmm_ell.py:133-189, 286-297). The port computes it
through K2, so the sums differ from the JAX package's only in f32 order.

On the card it is the hand-written CUDA kernel in ``csrc/ell_gather.cu``:
one pass over the layout's work items (:func:`selfrec_tpu_torch.ops.
spmm_ell.row_work`), where a short row's item writes its output row and a
long row's items write partials that a second, short pass adds in order.
No atomics, so runs repeat bit for bit; that file states its design and its
bound on an H100.

Everything the kernel needs from the layout is made once, when the layout
is built, and the partial buffer once per layout and row width; a call
checks only ``w`` and ``x``. :func:`ell_gather_sum` takes
:func:`ell_gather_sum_plain` only for CPU tensors; for CUDA tensors it
launches the kernel or raises. ``ell_gather_sum.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from selfrec_tpu_torch.ops import cuda_build

_lib = None
_lib_lock = threading.Lock()
_ready = set()  # devices that passed the capability check with the library loaded


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build("ell_gather.cu"))
            lib.selfrec_ell_gather_sum.restype = ctypes.c_int
            lib.selfrec_ell_gather_sum.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 6
                + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            _lib = lib
    return _lib


def ell_gather_sum_plain(layout, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch, independent of its work items:
    each virtual row's weighted gather (a gather and an einsum), summed into
    its destination row (``index_add_`` over ``vdst``)."""
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
    if (v, k) != (layout.vdst.shape[0], layout.k):
        raise ValueError(f"weights {tuple(w.shape)} do not fit the layout "
                         f"(V={layout.vdst.shape[0]}, K={layout.k})")
    if x.shape[1] % p:
        raise ValueError(f"width {x.shape[1]} is not {p} passes of equal width")
    if x.shape[0] < layout.n_src:
        raise ValueError(f"the layout gathers from {layout.n_src} rows, x has "
                         f"{x.shape[0]}")
    if not (w.device == x.device == layout.vidx.device):
        raise ValueError("ell_gather_sum operands lie on different devices")
    if not (w.is_contiguous() and x.is_contiguous()):
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
    lib = cuda_build.hopper_library(x.device, _ready, _load, "ell_gather_sum")
    p, v, k = w.shape
    c = x.shape[1]
    if (c // p) % 4 or x.data_ptr() % (4 * x.element_size()):
        raise ValueError(f"ell_gather_sum's kernel needs a pass width that is a "
                         f"multiple of 4 and x aligned to 4 elements, got {c // p}")
    n_items, n_long = layout.item_dst.shape[0], layout.long_rows.shape[0]
    # calls on one layout run in the order of the current stream, so one
    # partial buffer per width serves them all; a step graph's eager
    # warm-up makes it before any capture, so a replay finds it in place
    partial = layout.scratch.get(c)
    if partial is None:
        # every short row is one item, so the rest are the long rows' slots
        n_slots = n_items - (layout.n_rows - n_long)
        partial = torch.empty((n_slots, c), dtype=torch.float32, device=x.device)
        layout.scratch[c] = partial
    out = torch.empty((layout.n_rows, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.selfrec_ell_gather_sum(
            layout.vidx.data_ptr(), w.data_ptr(), x.data_ptr(),
            int(x.dtype == torch.bfloat16), layout.item_ptr.data_ptr(),
            layout.item_dst.data_ptr(), layout.long_rows.data_ptr(),
            layout.long_ptr.data_ptr(), partial.data_ptr(), out.data_ptr(),
            v, k, n_items, n_long, p, c // p, stream)
    if rc != 0:
        raise RuntimeError(f"ell_gather_sum kernel launch failed: CUDA error {rc}")
    ell_gather_sum.launches += 1
    return out


ell_gather_sum.launches = 0
