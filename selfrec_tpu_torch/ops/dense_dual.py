"""Dual-direction dense bipartite propagation: kernel K1 of the port.

    out_u = B @ xi        (U, I) x (I, D)
    out_i = B.T @ xu      (I, U) x (U, D)

over the (U, I) 0/1 int8 incidence block B with int8 operands and exact
int32 outputs. Replaces the Pallas kernel ``selfrec_tpu/ops/dense_dual.py``
(``_dual_kernel`` :122-152, ``_dual_call`` :155-201, ``dual_matmul``
:204-235), int8 variant. On the card it is the hand-written CUDA kernel in
``csrc/dense_dual.cu`` (mma.sync int8, one read of each B tile feeding both
products, int32 atomics for the item-direction sum across blocks); see that
file for its design and its bound on an H100.

The JAX package gates its kernel to D <= 128 from TPU timings
(dense_dual.py:79-83); that gate does not carry over, so here every int8
propagation goes through the kernel, at D = 64 (eval) and D = 192
(SimGCL's three packed chains). The float-operand variant of the TPU kernel
is never dispatched there (spmm_dense.py:459-462) and is not ported yet
(ROADMAP.md).

:func:`dual_matmul` takes :func:`dual_matmul_plain` only for CPU tensors; for
CUDA tensors it launches the kernel or raises. ``dual_matmul.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from selfrec_tpu_torch.ops import cuda_build

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build("dense_dual.cu"))
            lib.selfrec_dual_s8.restype = ctypes.c_int
            lib.selfrec_dual_s8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            lib.selfrec_dual_s8_supports.restype = ctypes.c_int
            lib.selfrec_dual_s8_supports.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


def dual_matmul_plain(b: torch.Tensor, xu: torch.Tensor,
                      xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch: (B @ xi, B.T @ xu) as int32.

    The products run in float64, which holds every partial sum of int8
    products exactly (|sum| <= 127 * max(U, I) << 2^53) and has a matmul on
    both the CPU and the card, then cast to int32: the result equals an
    int32 matmul bit for bit."""
    bd = b.to(torch.float64)
    out_u = (bd @ xi.to(torch.float64)).to(torch.int32)
    out_i = (bd.T @ xu.to(torch.float64)).to(torch.int32)
    return out_u, out_i


def _check(b, xu, xi):
    if not (b.dtype == xu.dtype == xi.dtype == torch.int8):
        raise TypeError(
            f"dual_matmul takes int8 operands, got {b.dtype}, {xu.dtype}, "
            f"{xi.dtype}; the float-operand variant is not ported (ROADMAP.md)")
    if b.dim() != 2 or xu.dim() != 2 or xi.dim() != 2:
        raise ValueError("dual_matmul takes 2-D tensors")
    u, i = b.shape
    if xu.shape[0] != u or xi.shape[0] != i or xu.shape[1] != xi.shape[1]:
        raise ValueError(f"shapes do not chain: b {tuple(b.shape)}, xu "
                         f"{tuple(xu.shape)}, xi {tuple(xi.shape)}")
    if not (b.device == xu.device == xi.device):
        raise ValueError("dual_matmul operands lie on different devices")


def dual_matmul(b: torch.Tensor, xu: torch.Tensor,
                xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B @ xi, B.T @ xu) with ONE streaming read of ``b``; int8 in, int32 out.

    CPU tensors take :func:`dual_matmul_plain`. CUDA tensors launch the
    Hopper kernel (sm_90) or raise."""
    _check(b, xu, xi)
    if b.device.type == "cpu":
        return dual_matmul_plain(b, xu, xi)
    if b.device.type != "cuda":
        raise RuntimeError(f"dual_matmul: no kernel for device {b.device}")
    u, i = b.shape
    d = xu.shape[1]
    if torch.cuda.get_device_capability(b.device) != (9, 0):
        raise RuntimeError("dual_matmul's kernel is built for sm_90a (Hopper); "
                           f"device {b.device} is sm_"
                           "%d%d" % torch.cuda.get_device_capability(b.device))
    lib = _load()
    if not lib.selfrec_dual_s8_supports(d):
        raise ValueError(f"dual_matmul's kernel is built for D in (64, 192), "
                         f"got D={d}")
    if b.stride(1) != 1 or not xu.is_contiguous() or not xi.is_contiguous():
        raise ValueError("dual_matmul needs row-major b and contiguous xu, xi")
    if xu.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError("dual_matmul needs 16-byte aligned xu, xi")
    out_u = torch.zeros((u, d), dtype=torch.int32, device=b.device)
    out_i = torch.zeros((i, d), dtype=torch.int32, device=b.device)
    with torch.cuda.device(b.device):
        n_sm = torch.cuda.get_device_properties(b.device).multi_processor_count
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = lib.selfrec_dual_s8(b.data_ptr(), xu.data_ptr(), xi.data_ptr(),
                                 out_u.data_ptr(), out_i.data_ptr(), u, i, d,
                                 b.stride(0), n_sm, stream)
    if rc != 0:
        raise RuntimeError(f"dual_matmul kernel launch failed: CUDA error {rc}")
    dual_matmul.launches += 1
    return out_u, out_i


dual_matmul.launches = 0
