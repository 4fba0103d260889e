"""Dual-direction dense bipartite propagation: kernel K1 of the port.

    out_u = B @ xi        (U, I) x (I, D)
    out_i = B.T @ xu      (I, U) x (U, D)

over the (U, I) 0/1 int8 incidence block B. Replaces the Pallas kernel
``selfrec_tpu/ops/dense_dual.py`` (``_dual_kernel`` :122-152, ``_dual_call``
:155-201, ``dual_matmul`` :204-235) with both of its variants:

- int8 operands, exact int32 outputs: the main path. Every int8
  propagation goes through it, at D = 64 (eval, SGL's dense arm) and
  D = 192 (SimGCL's three packed chains); the JAX package's D <= 128 gate
  came from TPU timings and does not carry over.
- bf16 or f32 operands of one dtype, f32 outputs, with an autograd
  backward that is the same kernel (``gxu = B @ g_i``, ``gxi = B.T @ g_u``,
  dense_dual.py:222-232). As in the JAX package no model path dispatches
  it (spmm_dense.py:459-462): the port's bf16 and f32 dense modes keep
  ``torch.matmul``.

On the card both are hand-written CUDA kernels in ``csrc/dense_dual.cu``
(int8: TMA and ``wgmma``; float: ``mma.sync`` bf16, f32 operands as three
bf16 pieces); that file states their design and bounds on an H100. Both
read B for the user direction and its transpose ``bt`` for the item
direction: callers pass the block's kept transpose (``DenseAdj.a_iu``,
made once a block by :func:`block_transpose`). The int8
kernel takes its operands K-major, so the wrapper hands it ``xu`` and ``xi``
transposed (:func:`k_major`), two small copies a call.

:func:`dual_matmul` takes :func:`dual_matmul_plain` only for CPU tensors;
for CUDA tensors it launches a kernel or raises. ``dual_matmul.launches``
counts launches of the int8 kernel and ``dual_matmul.float_launches`` those
of the float kernel, forward and backward.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from selfrec_tpu_torch.ops import cuda_build

_FLOAT = (torch.bfloat16, torch.float32)
_lib = None
_lib_lock = threading.Lock()
_ready = set()  # devices that passed the capability check with the library loaded


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build("dense_dual.cu"))
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.selfrec_dual_s8.restype = ctypes.c_int
            lib.selfrec_dual_s8.argtypes = [p, ll, p, ll, p, ll, p, ll, p, p, i, i, i, p]
            lib.selfrec_dual_float.restype = ctypes.c_int
            lib.selfrec_dual_float.argtypes = [p, ll, p, ll, p, p, i, p, p, i, i, i, p]
            lib.selfrec_dual_s8_supports.restype = ctypes.c_int
            lib.selfrec_dual_s8_supports.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


def pitched_empty(rows: int, cols: int, dtype, device) -> torch.Tensor:
    """An uninitialised (rows, cols) view whose row pitch is a multiple of
    16 bytes, as the kernels' tile copies need."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return torch.empty((rows, -(-cols // per) * per), dtype=dtype, device=device)[:, :cols]


def _pitched(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its rows are 16-byte aligned, else a pitched copy."""
    if (t.stride(1) == 1 and (t.stride(0) * t.element_size()) % 16 == 0
            and t.data_ptr() % 16 == 0):
        return t
    return pitched_empty(t.shape[0], t.shape[1], t.dtype, t.device).copy_(t)


def block_transpose(b: torch.Tensor) -> torch.Tensor:
    """B.T as an (I, U) int8 block with a 16-byte row pitch: what the
    kernels read for the item direction. 1.2 GB at yelp2018 scale, made
    once per block (``DenseAdj``)."""
    return pitched_empty(b.shape[1], b.shape[0], b.dtype, b.device).copy_(b.T)


def k_major(x: torch.Tensor) -> torch.Tensor:
    """x.T as a (D, n) view with a 16-byte row pitch: the int8 kernel's
    operand, contraction dimension contiguous."""
    return pitched_empty(x.shape[1], x.shape[0], x.dtype, x.device).copy_(x.T)


def dual_matmul_plain(b: torch.Tensor, xu: torch.Tensor,
                      xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' function in plain torch: (B @ xi, B.T @ xu), int32 for
    int8 operands and f32 for float ones.

    The products run in float64, which holds every partial sum of int8
    products exactly (|sum| <= 127 * max(U, I) << 2^53) and has a matmul on
    both the CPU and the card; cast to int32 the result equals an int32
    matmul bit for bit, and cast to f32 it is the correctly rounded f32
    product of the float operands."""
    out_dt = torch.int32 if xu.dtype == torch.int8 else torch.float32
    bd = b.to(torch.float64)
    out_u = (bd @ xi.to(torch.float64)).to(out_dt)
    out_i = (bd.T @ xu.to(torch.float64)).to(out_dt)
    return out_u, out_i


def _check(b, xu, xi, bt):
    if not (b.dtype == torch.int8 and xu.dtype == xi.dtype
            and xu.dtype in (torch.int8,) + _FLOAT):
        raise TypeError(
            f"dual_matmul takes an int8 block and xu, xi of one dtype (int8, "
            f"bfloat16 or float32), got {b.dtype}, {xu.dtype}, {xi.dtype}")
    if b.dim() != 2 or xu.dim() != 2 or xi.dim() != 2:
        raise ValueError("dual_matmul takes 2-D tensors")
    u, i = b.shape
    if xu.shape[0] != u or xi.shape[0] != i or xu.shape[1] != xi.shape[1]:
        raise ValueError(f"shapes do not chain: b {tuple(b.shape)}, xu "
                         f"{tuple(xu.shape)}, xi {tuple(xi.shape)}")
    if bt.dtype != torch.int8 or tuple(bt.shape) != (i, u):
        raise ValueError(f"bt must be b's (I, U) int8 transpose, got {bt.dtype} "
                         f"{tuple(bt.shape)}")
    if not (b.device == xu.device == xi.device == bt.device):
        raise ValueError("dual_matmul operands lie on different devices")


def _launch_s8(b, bt, xu, xi):
    lib = cuda_build.hopper_library(b.device, _ready, _load, "dual_matmul")
    u, i = b.shape
    d = xu.shape[1]
    if not lib.selfrec_dual_s8_supports(d):
        raise ValueError(f"dual_matmul's int8 kernel is built for D in (64, 192), "
                         f"got D={d}")
    if u == 0 or i == 0:
        raise ValueError("dual_matmul's kernel takes a non-empty block")
    b = _pitched(b)
    bt = _pitched(bt)
    xut, xit = k_major(xu), k_major(xi)
    out_u = torch.empty((u, d), dtype=torch.int32, device=b.device)
    out_i = torch.empty((i, d), dtype=torch.int32, device=b.device)
    with torch.cuda.device(b.device):
        rc = lib.selfrec_dual_s8(
            b.data_ptr(), b.stride(0), bt.data_ptr(), bt.stride(0), xut.data_ptr(),
            xut.stride(0), xit.data_ptr(), xit.stride(0), out_u.data_ptr(),
            out_i.data_ptr(), u, i, d, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dual_matmul int8 kernel launch failed: error {rc}")
    dual_matmul.launches += 1
    return out_u, out_i


def _float_products(b, bt, xu, xi):
    """(B @ xi, B.T @ xu) in f32 for float operands: the plain version on
    the CPU, the float kernel on the card."""
    if b.device.type == "cpu":
        return dual_matmul_plain(b, xu, xi)
    lib = cuda_build.hopper_library(b.device, _ready, _load, "dual_matmul")
    u, i = b.shape
    d = xu.shape[1]
    if d % 64 or u == 0 or i == 0:
        raise ValueError(f"dual_matmul's float kernel takes D a multiple of 64 and "
                         f"a non-empty block, got {tuple(b.shape)} and D={d}")
    b = _pitched(b)
    bt = _pitched(bt)
    xu, xi = xu.contiguous(), xi.contiguous()
    if xu.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError("dual_matmul's float kernel needs 16-byte aligned xu, xi")
    out_u = torch.empty((u, d), dtype=torch.float32, device=b.device)
    out_i = torch.empty((i, d), dtype=torch.float32, device=b.device)
    with torch.cuda.device(b.device):
        rc = lib.selfrec_dual_float(
            b.data_ptr(), b.stride(0), bt.data_ptr(), bt.stride(0), xu.data_ptr(),
            xi.data_ptr(), int(xu.dtype == torch.bfloat16), out_u.data_ptr(),
            out_i.data_ptr(), u, i, d, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dual_matmul float kernel launch failed: error {rc}")
    dual_matmul.float_launches += 1
    return out_u, out_i


class _DualFloat(torch.autograd.Function):
    """Float operands; the backward is the same dual product over the
    cotangents cast to the operands' dtype (dense_dual.py:215-232): the
    block is a graph constant and gets no gradient."""

    @staticmethod
    def forward(ctx, b, bt, xu, xi):
        ctx.save_for_backward(b, bt)
        ctx.dtype = xu.dtype
        return _float_products(b, bt, xu, xi)

    @staticmethod
    def backward(ctx, g_u, g_i):
        b, bt = ctx.saved_tensors
        dt = ctx.dtype
        gxu, gxi = _float_products(b, bt, g_u.to(dt), g_i.to(dt))
        return None, None, gxu.to(dt), gxi.to(dt)


def dual_matmul(b: torch.Tensor, xu: torch.Tensor, xi: torch.Tensor,
                bt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B @ xi, B.T @ xu) over the int8 block ``b``: int32 for int8
    operands, f32 (differentiable in ``xu`` and ``xi``) for bf16 or f32.

    ``bt`` is ``b``'s transpose (:func:`block_transpose`), kept with the
    block. CPU tensors take
    :func:`dual_matmul_plain`. CUDA tensors launch the Hopper kernels
    (sm_90a) or raise."""
    _check(b, xu, xi, bt)
    if b.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"dual_matmul: no kernel for device {b.device}")
    if xu.dtype in _FLOAT:
        return _DualFloat.apply(b, bt, xu, xi)
    if b.device.type == "cpu":
        return dual_matmul_plain(b, xu, xi)
    return _launch_s8(b, bt, xu, xi)


dual_matmul.launches = 0
dual_matmul.float_launches = 0
