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
  dense_dual.py:222-232). The port's bf16 and f32 dense modes run its
  products (:func:`float_products`) with a backward of their own, over the
  f32 cotangents (``spmm_dense._DenseFloat``); the JAX package runs those
  modes through XLA's dot instead.

On the card both are hand-written CUDA kernels in ``csrc/dense_dual.cu`` on
one TMA + ``wgmma`` skeleton; that file states their design and bounds on
an H100. Both read B for the user direction and its transpose ``bt`` for
the item direction: callers pass the block's kept transpose
(``DenseAdj.a_iu``, made once a block by :func:`block_transpose`). Both
take their operands K-major, so the wrapper hands them ``xu`` and ``xi``
transposed, two small copies a call: as they are for int8 (:func:`k_major`),
in bf16 with the contraction index permuted for the float kernel
(:func:`float_operand`, one fused pass on the card; f32 split into pieces
as :func:`split_f32` does).

Any D >= 1 is taken (:func:`width_plan`): D is padded with zero columns to
a multiple of 64 and run in column chunks of at most 192, each of which
reads B once more; the outputs are sliced back.

:func:`dual_matmul` takes :func:`dual_matmul_plain` only for CPU tensors;
for CUDA tensors it launches a kernel or raises. ``dual_matmul.launches``
counts launches of the int8 kernel and ``float_products.launches`` those of
the float kernel, forward and backward.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from selfrec_tpu_torch.ops import cuda_build

_FLOAT = (torch.bfloat16, torch.float32)
CHUNK_MAX = 192  # widest output chunk the kernels are built for (N = 64, 128, 192)
K_TILE = 128     # contraction indices a kernel stage; float operands are padded to it
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
            lib.selfrec_dual_s8.argtypes = [p, ll, p, ll, p, ll, p, ll, p, p, i, i, i, i, i, p]
            lib.selfrec_dual_float.restype = ctypes.c_int
            lib.selfrec_dual_float.argtypes = [p, ll, p, ll, p, ll, p, ll, i, p, p, i, i, i,
                                               i, i, p]
            lib.selfrec_float_operand.restype = ctypes.c_int
            lib.selfrec_float_operand.argtypes = [p, i, ll, i, i, i, p, i, i, p]
            _lib = lib
    return _lib


class WidthPlan(NamedTuple):
    """How the kernels cover D output columns: ``chunks`` column chunks
    (the grid's y dimension), each ``n`` operand columns wide; with
    ``pieces`` = 3 (f32 operands) a chunk holds three bf16 pieces of n / 3
    output columns."""
    n: int
    chunks: int
    pieces: int

    @property
    def x_width(self) -> int:
        """Operand columns the kernel reads: D padded (f32: three pieces)."""
        return self.n * self.chunks

    @property
    def out_width(self) -> int:
        """Output columns the kernel writes, D padded."""
        return self.x_width // self.pieces


def width_plan(d: int, pieces: int = 1) -> WidthPlan:
    """D padded to a multiple of 64 and cut into equal chunks of at most
    192 columns (64, 128 or 192); f32 operands (``pieces`` = 3) in chunks of
    64 output columns, whose three pieces make 192 operand columns. Zero
    columns add nothing, so int8 stays exact."""
    if d < 1:
        raise ValueError(f"dual_matmul takes D >= 1, got D={d}")
    groups = -(-d // 64)
    if pieces == 3:
        return WidthPlan(CHUNK_MAX, groups, 3)
    chunks = -(-groups // (CHUNK_MAX // 64))
    return WidthPlan(64 * -(-groups // chunks), chunks, 1)


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


def split_f32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``x`` as bf16 pieces (hi, mid, lo) with
    ``x == hi + 2**-8 * mid + 2**-16 * lo`` exactly, for every finite x.

    Each piece is its remainder cut to its top 16 bits (bf16 rounded toward
    zero, so no piece overflows), and each remainder is scaled by 2^8
    before it is cut: 24 significant bits in three pieces of 8, and a
    remainder below bf16's smallest subnormal (2^-133) never has to be
    represented, so subnormals and tiny values split exactly too. The
    remainders are exact: x and its truncation share sign and binade."""
    def top16(v):
        bits = v.view(torch.int32)
        return (bits & -65536).view(torch.float32), (bits >> 16).to(torch.int16).view(
            torch.bfloat16)

    hi_f, hi = top16(x)
    r1 = (x - hi_f) * 256.0
    mid_f, mid = top16(r1)
    _, lo = top16((r1 - mid_f) * 256.0)
    return hi, mid, lo


def float_operand_plain(x: torch.Tensor, plan: WidthPlan) -> torch.Tensor:
    """The float kernel's operand: (plan.x_width, n128) bf16, K-major, with
    n padded with zeros to a multiple of 128 and D to the plan's width.
    An f32 x goes in as :func:`split_f32`'s pieces, side by side in groups
    of 64 columns ([hi_0 mid_0 lo_0 | hi_1 mid_1 lo_1 | ...]). Inside each
    16 contraction indices, position 8h + 2t + j holds index 4t + 2h + j:
    the order in which a kernel thread's A fragment reads B's bytes."""
    n, d = x.shape
    n_pad = -(-n // K_TILE) * K_TILE
    if plan.pieces == 3:
        pieces = torch.stack(split_f32(x.float().contiguous()))  # (3, n, d)
        w = F.pad(pieces, (0, plan.out_width - d, 0, n_pad - n))
        w = w.view(3, n_pad, plan.out_width // 64, 64).permute(1, 2, 0, 3)
    else:
        w = F.pad(x.to(torch.bfloat16), (0, plan.x_width - d, 0, n_pad - n))
    w = w.reshape(n_pad // 16, 4, 2, 2, plan.x_width)
    return w.permute(4, 0, 2, 1, 3).reshape(plan.x_width, n_pad)


def float_operand(x: torch.Tensor, plan: WidthPlan) -> torch.Tensor:
    """:func:`float_operand_plain`'s result, bit for bit: the plain version
    for a CPU tensor, one pass of ``float_operand_kernel`` (split, pad,
    permute and transpose fused) for a CUDA tensor."""
    if x.device.type == "cpu":
        return float_operand_plain(x, plan)
    lib = cuda_build.hopper_library(x.device, _ready, _load, "dual_matmul")
    if x.stride(1) != 1:
        x = x.contiguous()
    n, d = x.shape
    n_pad = -(-n // K_TILE) * K_TILE
    out = torch.empty((plan.x_width, n_pad), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.selfrec_float_operand(
            x.data_ptr(), int(x.dtype == torch.float32), x.stride(0), n, d, plan.pieces,
            out.data_ptr(), plan.x_width, n_pad, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dual_matmul operand pass launch failed: error {rc}")
    return out


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


def _launch(fn, b, bt, xut, xit, plan, out_dtype, *extra):
    """One launch of a kernel of the library over the block, the K-major
    operands and every chunk of ``plan``; returns the outputs sliced to D
    (copied when D was padded, so that they are contiguous)."""
    u, i = b.shape
    if u == 0 or i == 0:
        raise ValueError("dual_matmul's kernels take a non-empty block")
    b = _pitched(b)
    bt = _pitched(bt)
    w = plan.out_width
    out_u = torch.empty((u, w), dtype=out_dtype, device=b.device)
    out_i = torch.empty((i, w), dtype=out_dtype, device=b.device)
    esz = xut.element_size()
    with torch.cuda.device(b.device):
        rc = fn(b.data_ptr(), b.stride(0), bt.data_ptr(), bt.stride(0), xut.data_ptr(),
                xut.stride(0) * esz, xit.data_ptr(), xit.stride(0) * esz, *extra,
                out_u.data_ptr(), out_i.data_ptr(), w, u, i, plan.n, plan.chunks,
                torch.cuda.current_stream().cuda_stream)
    return rc, out_u, out_i


def _sliced(out, d):
    return out if out.shape[1] == d else out[:, :d].contiguous()


def _launch_s8(b, bt, xu, xi):
    lib = cuda_build.hopper_library(b.device, _ready, _load, "dual_matmul")
    d = xu.shape[1]
    plan = width_plan(d)
    if plan.x_width != d:
        xu = F.pad(xu, (0, plan.x_width - d))
        xi = F.pad(xi, (0, plan.x_width - d))
    rc, out_u, out_i = _launch(lib.selfrec_dual_s8, b, bt, k_major(xu), k_major(xi), plan,
                               torch.int32)
    if rc != 0:
        raise RuntimeError(f"dual_matmul int8 kernel launch failed: error {rc}")
    dual_matmul.launches += 1
    return _sliced(out_u, d), _sliced(out_i, d)


def float_products(b, bt, xu, xi):
    """(B @ xi, B.T @ xu) in f32 for float operands of one dtype, with no
    autograd: the plain version on the CPU, the float kernel on the card
    (counted in ``float_products.launches``)."""
    _check(b, xu, xi, bt)
    if xu.dtype not in _FLOAT:
        raise TypeError(f"float_products takes bfloat16 or float32 operands, got {xu.dtype}")
    if b.device.type == "cpu":
        return dual_matmul_plain(b, xu, xi)
    lib = cuda_build.hopper_library(b.device, _ready, _load, "dual_matmul")
    d = xu.shape[1]
    plan = width_plan(d, 3 if xu.dtype == torch.float32 else 1)
    rc, out_u, out_i = _launch(lib.selfrec_dual_float, b, bt, float_operand(xu, plan),
                               float_operand(xi, plan), plan, torch.float32, plan.pieces)
    if rc != 0:
        raise RuntimeError(f"dual_matmul float kernel launch failed: error {rc}")
    float_products.launches += 1
    return _sliced(out_u, d), _sliced(out_i, d)


float_products.launches = 0


class _DualFloat(torch.autograd.Function):
    """Float operands; the backward is the same dual product over the
    cotangents cast to the operands' dtype (dense_dual.py:215-232): the
    block is a graph constant and gets no gradient."""

    @staticmethod
    def forward(ctx, b, bt, xu, xi):
        ctx.save_for_backward(b, bt)
        ctx.dtype = xu.dtype
        return float_products(b, bt, xu, xi)

    @staticmethod
    def backward(ctx, g_u, g_i):
        b, bt = ctx.saved_tensors
        dt = ctx.dtype
        gxu, gxi = float_products(b, bt, g_u.to(dt), g_i.to(dt))
        return None, None, gxu.to(dt), gxi.to(dt)


def dual_matmul(b: torch.Tensor, xu: torch.Tensor, xi: torch.Tensor,
                bt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B @ xi, B.T @ xu) over the 0/1 int8 block ``b``: int32 for int8
    operands, f32 (differentiable in ``xu`` and ``xi``) for bf16 or f32,
    at any D >= 1.

    ``bt`` is ``b``'s transpose (:func:`block_transpose`), kept with the
    block. CPU tensors take :func:`dual_matmul_plain`. CUDA tensors launch
    the Hopper kernels (sm_90a) or raise; the float kernel reads B's
    entries as 0 or 1, which an incidence block holds."""
    _check(b, xu, xi, bt)
    if b.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"dual_matmul: no kernel for device {b.device}")
    if xu.dtype in _FLOAT:
        return _DualFloat.apply(b, bt, xu, xi)
    if b.device.type == "cpu":
        return dual_matmul_plain(b, xu, xi)
    return _launch_s8(b, bt, xu, xi)


dual_matmul.launches = 0
