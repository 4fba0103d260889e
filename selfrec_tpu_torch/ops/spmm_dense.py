"""Dense-bipartite adjacency propagation (counterpart of
``selfrec_tpu/ops/spmm_dense.py``).

The symmetric normalized Laplacian every LightGCN-family model propagates
over is bipartite: its (U+I)x(U+I) matrix has nonzeros only in a (U, I)
block A and its transpose, so one propagation is

    out_users = A @ x_items        out_items = A.T @ x_users

over ONE stored (U, I) buffer. In the factored mode the buffer is the binary
incidence B as int8 and the normalization is exact f32 diagonal scalings,
``A = gain * diag(row_scale) @ B @ diag(col_scale)``.

Matmul modes follow ``SELFREC_TPU_DENSE_DTYPE`` (``bfloat16`` default,
``float32``, ``int8``) as in the JAX package. Every factored block runs
through kernel K1 (:mod:`selfrec_tpu_torch.ops.dense_dual`), over B and its
kept transpose ``a_iu``:

- ``int8`` quantizes each operand per channel to int8 (K1's int8 kernel),
  with the straight-through backward of spmm_dense.py:482-506;
- ``bfloat16`` and ``float32`` round the scaled operand to the matmul
  dtype and sum in f32 (K1's float kernel), as ``dot_general`` with
  ``preferred_element_type=f32`` does (spmm_dense.py:532-547). The
  backward multiplies the f32 cotangent by B and rounds only the product
  to the operand dtype, as JAX's VJP of that dot does.

The generic (arbitrary weight) mode multiplies its value block in f32 with
``torch.matmul`` (the JAX package leaves it to XLA outside any kernel).

SGL's per-epoch dropped views stay factored through
:meth:`DenseAdj.refactor_view`, and BUIR's per-step views through
:meth:`DenseAdj.dropout_view`.

:class:`DenseMat` holds any static (M, N) matrix (MHCN's motif channels and
R, SEPT's social views) as one value block in ``_generic_dtype()``;
:func:`dense_mat_spmm` multiplies it with f32 sums (a library GEMM, as the
JAX package leaves this product to XLA).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from selfrec_tpu_torch.device import full_f32_matmul
from selfrec_tpu_torch.ops import dense_dual

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def _dense_dtype() -> torch.dtype:
    name = os.environ.get("SELFREC_TPU_DENSE_DTYPE", "bfloat16")
    if name not in _DTYPES:
        raise ValueError(f"SELFREC_TPU_DENSE_DTYPE={name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


def _generic_dtype() -> torch.dtype:
    """Value-block dtype for NON-factored mode: arbitrary per-edge weights in
    an int8 block would be garbage, so generic blocks use bf16 under the
    int8 opt-in (spmm_dense.py:52-58)."""
    d = _dense_dtype()
    return torch.bfloat16 if d == torch.int8 else d


class DenseAdj:
    """Bipartite normalized adjacency held as a dense (U, I) block.

    - **factored** (``row_scale is not None``): ``a_ui`` is the binary int8
      incidence; ``row_scale`` (U,), ``col_scale`` (I,) and the scalar
      ``gain`` carry the normalization exactly.
    - **generic** (``row_scale is None``): ``a_ui`` holds arbitrary per-edge
      weights in a float dtype.

    A factored block keeps ``a_iu``, B's (I, U) transpose, for K1's item
    direction in every matmul mode (:func:`dense_dual.block_transpose`,
    or ``a_iu`` when the caller made it already); a generic block has
    none."""

    def __init__(self, a_ui, edge_users, edge_items, edge_w, n_users: int,
                 n_items: int, row_scale=None, col_scale=None, gain=None,
                 mm_dtype=torch.bfloat16, a_iu=None):
        self.a_ui = a_ui
        self.edge_users = edge_users
        self.edge_items = edge_items
        self.edge_w = edge_w
        self.row_scale = row_scale
        self.col_scale = col_scale
        self.gain = gain
        self.mm_dtype = mm_dtype
        self.n_users = n_users
        self.n_items = n_items
        self.n_nodes = n_users + n_items
        self.a_iu = None
        if self.factored:
            self.a_iu = dense_dual.block_transpose(a_ui) if a_iu is None else a_iu

    @property
    def factored(self) -> bool:
        return self.row_scale is not None

    @property
    def device(self) -> torch.device:
        return self.a_ui.device

    def refactor_view(self, keep: torch.Tensor) -> "DenseAdj":
        """Symmetric-renormalized dropped view that stays int8-factored
        (spmm_dense.py:175-198): the kept-edge Laplacian is a new binary
        incidence with diagonal scalings 1/sqrt over the recomputed degrees
        (reference SGL.py:89-96). ``keep`` is (E,) bool over this block's
        edge order (see :func:`adj_edge_perm`). The view keeps its own
        transpose for K1, as every factored block does."""
        kf = keep.to(torch.float32)
        du = torch.zeros(self.n_users, dtype=torch.float32, device=kf.device)
        di = torch.zeros(self.n_items, dtype=torch.float32, device=kf.device)
        du.index_add_(0, self.edge_users, kf)
        di.index_add_(0, self.edge_items, kf)
        ru = torch.where(du > 0, torch.rsqrt(torch.clamp(du, min=1e-12)), 0.0)
        ci = torch.where(di > 0, torch.rsqrt(torch.clamp(di, min=1e-12)), 0.0)
        b = _zero_block(self.n_users, self.n_items, kf.device)
        b.index_put_((self.edge_users, self.edge_items), keep.to(torch.int8),
                     accumulate=True)
        w = kf * ru[self.edge_users] * ci[self.edge_items]
        return DenseAdj(b, self.edge_users, self.edge_items, w, self.n_users,
                        self.n_items, ru, ci,
                        torch.tensor(1.0, dtype=torch.float32, device=kf.device),
                        mm_dtype=self.mm_dtype)

    def dropout_view(self, rate, keep=None, generator=None) -> "DenseAdj":
        """Per-step sparse dropout (spmm_dense.py:125-173; reference
        BUIR.py:118-127): keep each edge with probability 1 - rate and
        scale the kept weights by 1 / (1 - rate), with no degree
        renormalization. ``rate`` may be a 0-d tensor (BUIR draws it each
        forward).

        A factored block stays factored: B ⊙ keep is binary and the scale
        goes into ``gain``. By default the keep draw is per edge (the JAX
        package's CPU default, ``SELFREC_TPU_DROPOUT_MASK=scatter``): ``keep``
        (E,) bool over this block's edge order (:func:`adj_edge_perm`), or
        ``rand(E) >= rate`` from ``generator``, set into B at (u, i) and
        into a copy of the kept transpose at (i, u). A factored block has no
        duplicate edges (:func:`_try_factor`), so setting an entry equals
        multiplying it. The JAX package's per-position mask
        (``SELFREC_TPU_DROPOUT_MASK=fused``, its accelerator default) is not
        ported and raises; on a binary block its edges' keep distribution is
        the per-edge draw's. Generic blocks draw per edge and multiply,
        duplicates included."""
        mode = os.environ.get("SELFREC_TPU_DROPOUT_MASK", "scatter")
        if mode != "scatter":
            raise NotImplementedError(
                f"SELFREC_TPU_DROPOUT_MASK={mode}: the port draws the keep mask per "
                "edge only; the per-position mask is not ported (ROADMAP.md); unset "
                "it or set it to 'scatter'")
        inv = 1.0 / (1.0 - rate)
        if keep is None:
            keep = torch.rand(self.edge_w.shape, generator=generator,
                              device=self.device) >= rate
        if self.factored:
            k8 = keep.to(torch.int8)
            b = _pitched_copy(self.a_ui)
            b.index_put_((self.edge_users, self.edge_items), k8)
            bt = _pitched_copy(self.a_iu)
            bt.index_put_((self.edge_items, self.edge_users), k8)
            return DenseAdj(b, self.edge_users, self.edge_items, self.edge_w,
                            self.n_users, self.n_items, self.row_scale,
                            self.col_scale, self.gain * inv, mm_dtype=self.mm_dtype,
                            a_iu=bt)
        flat = self.a_ui.reshape(-1).clone()
        flat.scatter_reduce_(0, self.edge_users * self.n_items + self.edge_items,
                             keep.to(flat.dtype), reduce="prod")
        b = flat.reshape(self.a_ui.shape)
        inv_t = torch.as_tensor(inv, dtype=torch.float32, device=self.device)
        return DenseAdj(b * inv_t.to(b.dtype), self.edge_users, self.edge_items,
                        self.edge_w, self.n_users, self.n_items, mm_dtype=b.dtype)

    def __repr__(self):
        mode = ("int8-factored" if self.factored else str(self.a_ui.dtype))
        gb = self.a_ui.numel() * self.a_ui.element_size() / 1e9
        return (f"DenseAdj(U={self.n_users}, I={self.n_items}, {mode}, "
                f"mm={self.mm_dtype}, {gb:.2f} GB)")


def _zero_block(rows: int, cols: int, device) -> torch.Tensor:
    """A zero (rows, cols) int8 incidence block with the 16-byte row pitch
    K1 reads, so that no launch has to copy it into one."""
    return dense_dual.pitched_empty(rows, cols, torch.int8, device).zero_()


def _pitched_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of the 2-D ``t`` with the same 16-byte row pitch K1 reads.
    A pitched view (:func:`dense_dual.pitched_empty`) is copied with its
    padding as one contiguous block: a plain device-to-device copy, where
    copying the strided view element by element took 2.6 ms for the
    yelp2018-scale transpose on an H100 (PERF.md, §5)."""
    rows, cols = t.shape
    pitch = t.stride(0)
    if (t.stride(1) == 1 and t.storage_offset() == 0 and pitch >= cols
            and t.untyped_storage().nbytes() >= rows * pitch * t.element_size()):
        return t.as_strided((rows, pitch), (pitch, 1)).clone()[:, :cols]
    return dense_dual.pitched_empty(rows, cols, t.dtype, t.device).copy_(t)


def _try_factor(edge_users, edge_items, w, n_users, n_items):
    """Detect the symmetric-normalization structure w = 1/sqrt(du*di)
    (or a constant multiple of it) from the edge weights. Returns
    (row_scale, col_scale, gain) numpy arrays, or None. Same rules as
    spmm_dense.py:233-262."""
    eu = np.asarray(edge_users)
    ei = np.asarray(edge_items)
    w = np.asarray(w, dtype=np.float64)
    if len(w) == 0 or np.any(w <= 0):
        return None
    # duplicate (user, item) edges can't be a binary incidence
    if len(np.unique(eu.astype(np.int64) * (n_items + 1) + ei)) != len(eu):
        return None
    du = np.bincount(eu, minlength=n_users).astype(np.float64)
    di = np.bincount(ei, minlength=n_items).astype(np.float64)
    ru = 1.0 / np.sqrt(np.maximum(du, 1.0))
    ci = 1.0 / np.sqrt(np.maximum(di, 1.0))
    ratio = w / (ru[eu] * ci[ei])
    gain = float(ratio[0])
    if np.max(np.abs(ratio - gain)) <= 1e-5 * gain:
        return (ru.astype(np.float32), ci.astype(np.float32), gain)
    c = float(w[0])
    if np.max(np.abs(w - c)) <= 1e-6 * max(abs(c), 1e-30):
        return (np.ones(n_users, np.float32), np.ones(n_items, np.float32), c)
    return None


def check_edge_index(name: str, t: torch.Tensor, host: np.ndarray, n: int) -> None:
    """Raise, naming the bad positions, unless the index tensor ``t`` on
    its device equals ``host`` and every entry lies in [0, n).

    One build of the dense block on the card once failed in the
    ``index_put`` below on an out-of-range index at periodic positions,
    though the host indices are in range by construction (PERF.md, open
    questions); this makes such a fault name itself at build time."""
    back = t.cpu().numpy()
    bad = np.nonzero((back != host) | (back < 0) | (back >= n))[0]
    if len(bad):
        first = bad[:8]
        raise RuntimeError(
            f"{name} on {t.device}: {len(bad)} of {len(host)} entries differ from "
            f"the host array or leave [0, {n}); positions {first.tolist()} hold "
            f"{back[first].tolist()}, the host has {host[first].tolist()}")


def dense_adj_from_edges(edge_users, edge_items, w, n_users: int,
                         n_items: int, dtype=None, device="cuda") -> DenseAdj:
    """Build the dense block on ``device`` from (user, item, weight) edges.

    Symmetric-normalized (or constant) weights get the exact int8-factored
    form; anything else, or an explicit ``dtype``, a generic value block.
    Duplicate edges SUM in the generic block, like the sparse paths."""
    device = torch.device(device)
    eu_host = np.asarray(edge_users, dtype=np.int64)
    ei_host = np.asarray(edge_items, dtype=np.int64)
    eu = torch.as_tensor(eu_host, device=device)
    ei = torch.as_tensor(ei_host, device=device)
    check_edge_index("edge_users", eu, eu_host, n_users)
    check_edge_index("edge_items", ei, ei_host, n_items)
    w32 = torch.as_tensor(np.asarray(w, dtype=np.float32), device=device)
    if dtype is None:
        fac = _try_factor(edge_users, edge_items, w, n_users, n_items)
        if fac is not None:
            ru, ci, gain = fac
            b = _zero_block(n_users, n_items, device)
            b[eu, ei] = 1
            return DenseAdj(b, eu, ei, w32, n_users, n_items,
                            torch.as_tensor(ru, device=device),
                            torch.as_tensor(ci, device=device),
                            torch.tensor(gain, dtype=torch.float32, device=device),
                            mm_dtype=_dense_dtype())
        dtype = _generic_dtype()
    a = torch.zeros((n_users, n_items), dtype=dtype, device=device)
    a.index_put_((eu, ei), w32.to(dtype), accumulate=True)
    return DenseAdj(a, eu, ei, w32, n_users, n_items, mm_dtype=dtype)


def adj_edge_perm(adj: DenseAdj, edge_users, edge_items, n_items: int) -> np.ndarray:
    """perm[j] = dataset-edge index of the block's j-th edge, so a keep-mask
    drawn in dataset edge order applies to the block's edge order (the
    block is built from the scipy COO of norm_adj, whose order differs;
    spmm_dense.py:353-370)."""
    eu = np.asarray(edge_users)
    ei = np.asarray(edge_items)
    data_key = eu.astype(np.int64) * n_items + ei
    adj_key = (adj.edge_users.cpu().numpy().astype(np.int64) * n_items
               + adj.edge_items.cpu().numpy())
    order = np.argsort(data_key)
    pos = np.searchsorted(data_key[order], adj_key)
    pos = np.minimum(pos, len(order) - 1)
    if not np.array_equal(data_key[order][pos], adj_key):
        raise ValueError("adjacency edges are not a permutation of the dataset edges")
    return order[pos].astype(np.int32)


def fits_dense_elems(n_elems: int, dtype=None) -> bool:
    """Whether ``n_elems`` dense values of ``dtype`` (default the dense
    mode's) fit the configured device-memory budget
    (``SELFREC_TPU_DENSE_BUDGET_GB``, default 5; spmm_dense.py:290-299)."""
    budget_gb = float(os.environ.get("SELFREC_TPU_DENSE_BUDGET_GB", "5"))
    itemsize = torch.empty((), dtype=dtype or _dense_dtype()).element_size()
    return n_elems * itemsize <= budget_gb * 1e9


def fits_dense(n_users: int, n_items: int, dtype=None) -> bool:
    """Whether one dense (n_users, n_items) block of ``dtype`` fits the
    budget."""
    return fits_dense_elems(n_users * n_items, dtype)


def bipartite_blocks(coo, n_users: int):
    """Split a unified (U+I)x(U+I) COO Laplacian into bipartite (u, i, w)
    edge arrays, or None if any nonzero lives in a diagonal block or the
    lower block is not the upper block's transpose (spmm_dense.py:389-422)."""
    row, col, dat = coo.row, coo.col, coo.data
    upper = (row < n_users) & (col >= n_users)
    lower = (row >= n_users) & (col < n_users)
    if not np.all(upper | lower):
        return None
    eu = row[upper].astype(np.int32)
    ei = (col[upper] - n_users).astype(np.int32)
    w = dat[upper].astype(np.float32)
    lu = col[lower].astype(np.int32)
    li = (row[lower] - n_users).astype(np.int32)
    lw = dat[lower].astype(np.float32)
    if len(lu) != len(eu):
        return None
    ku = np.lexsort((ei, eu))
    kl = np.lexsort((li, lu))
    if not (np.array_equal(eu[ku], lu[kl]) and np.array_equal(ei[ku], li[kl])
            and np.array_equal(w[ku], lw[kl])):
        return None
    return eu, ei, w


def _quant_per_channel(y: torch.Tensor):
    """Symmetric per-channel (per-D-column) int8 quantization.

    scale_d = max|y[:, d]| / 127; yq = clip(round(y / scale)) in [-127, 127],
    rounding half to even like ``jnp.round``. Returns (yq int8, scale f32
    (1, D)). Zero columns get scale 1."""
    amax = torch.amax(torch.abs(y), dim=0, keepdim=True)
    # a tensor divisor: torch on CUDA divides by a Python scalar through its
    # reciprocal, one ulp off the CPU's (and JAX's) true division
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    yq = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return yq, scale


def _dense_spmm_int8_apply(adj: DenseAdj, x: torch.Tensor) -> torch.Tensor:
    """int8 x int8 propagation through kernel K1 (spmm_dense.py:437-479).

    Accumulation is int32 and exact; the only approximation is the
    per-channel operand quantization."""
    xu = x[: adj.n_users]
    xi = x[adj.n_users:]
    ru = adj.row_scale[:, None] * adj.gain
    ci = adj.col_scale[:, None]
    yq, ys = _quant_per_channel(ci * xi)
    zq, zs = _quant_per_channel(ru * xu)
    ou_raw, oi_raw = dense_dual.dual_matmul(adj.a_ui, zq, yq, adj.a_iu)
    out_u = ru * (ou_raw.to(torch.float32) * ys)
    out_i = ci * (oi_raw.to(torch.float32) * zs)
    return torch.cat([out_u, out_i], dim=0).to(x.dtype)


class _DenseSpmmInt8(torch.autograd.Function):
    """The unified Laplacian is symmetric, so the cotangent propagates
    through the SAME quantized apply; quantization is straight-through
    (spmm_dense.py:491-503). This is not the exact transpose: the cotangent
    is quantized too."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return _dense_spmm_int8_apply(adj, x)

    @staticmethod
    def backward(ctx, g):
        return _dense_spmm_int8_apply(ctx.adj, g.contiguous()), None


class _DenseFloat(torch.autograd.Function):
    """(B @ yi, B.T @ zu) in f32 for operands of one float dtype: K1's float
    kernel on the card, its plain version on the CPU
    (:func:`dense_dual.float_products`).

    The backward is JAX's VJP of ``dot_general(B, y.astype(mmd),
    preferred_element_type=f32)``: the same dual product over the f32
    cotangents (K1's f32-operand variant on the card), rounded to the
    operands' dtype only after the sum. This differs from ``dual_matmul``'s
    own backward, the Pallas kernel's VJP, which rounds the cotangents
    first."""

    @staticmethod
    def forward(ctx, zu, yi, b, bt):
        ctx.save_for_backward(b, bt)
        ctx.dtype = zu.dtype
        return dense_dual.float_products(b, bt, zu, yi)

    @staticmethod
    def backward(ctx, g_u, g_i):
        b, bt = ctx.saved_tensors
        gzu, gyi = dense_dual.float_products(b, bt, g_u.float().contiguous(),
                                             g_i.float().contiguous())
        return gzu.to(ctx.dtype), gyi.to(ctx.dtype), None, None


def _generic_products(a: torch.Tensor, xu: torch.Tensor, xi: torch.Tensor):
    """(A @ xi, A.T @ xu) for a value block A: the operands rounded to A's
    dtype, every product exact in f32 and summed in f32, as ``jnp.dot(...,
    preferred_element_type=f32)`` does (spmm_dense.py:548-552)."""
    af = a.float()
    return af @ xi.to(a.dtype).float(), af.T @ xu.to(a.dtype).float()


def dense_spmm(adj: DenseAdj, x: torch.Tensor) -> torch.Tensor:
    """Unified-node-space propagation: x is ((U+I), D) in [users; items]
    order; returns [A @ x_i ; A.T @ x_u] (spmm_dense.py:509-553).

    Factored: out_u = gain * ru . (B @ (ci . x_i)),
              out_i = gain * ci . (B' @ (ru . x_u))  (gain folded into ru),
    through K1 in every matmul mode; the bf16 and f32 modes sum in f32."""
    if adj.factored and adj.mm_dtype == torch.int8:
        return _DenseSpmmInt8.apply(x, adj)
    xu = x[: adj.n_users]
    xi = x[adj.n_users:]
    if adj.factored:
        mmd = adj.mm_dtype
        ru = adj.row_scale[:, None] * adj.gain
        ci = adj.col_scale[:, None]
        ou, oi = _DenseFloat.apply((ru * xu).to(mmd), (ci * xi).to(mmd), adj.a_ui, adj.a_iu)
        out_u = ru * ou
        out_i = ci * oi
    else:
        out_u, out_i = _generic_products(adj.a_ui, xu, xi)
    return torch.cat([out_u, out_i], dim=0).to(x.dtype)


class DenseMat:
    """A static dense (M, N) matrix of arbitrary values in one block of
    ``_generic_dtype()`` (bf16 by default and under the int8 opt-in, f32
    under ``SELFREC_TPU_DENSE_DTYPE=float32``; spmm_dense.py:310-345):
    MHCN's motif hypergraphs H_s, H_j, H_p (U × U) and its rating blocks R
    (U × I) and Rᵀ, SEPT's social views. The backward multiplies by the
    same block's transpose; no second copy is kept. The block's rows are
    16-byte aligned (:func:`dense_dual.pitched_empty`): cuBLAS takes a
    Turing-era ``align1`` GEMM for a bf16 block whose row length is not a
    multiple of 8, 3.3× slower for R's backward at douban scale (PERF.md)."""

    def __init__(self, a: torch.Tensor):
        self.a = dense_dual._pitched(a)
        self.n_nodes = a.shape[0]

    @property
    def shape(self):
        return tuple(self.a.shape)

    def __repr__(self):
        gb = self.a.numel() * self.a.element_size() / 1e9
        return f"DenseMat({self.a.shape[0]}x{self.a.shape[1]}, {self.a.dtype}, {gb:.3f} GB)"


def dense_mat_from_scipy(mat, device="cuda") -> DenseMat:
    """The block built on ``device`` from a host scipy matrix by one
    scatter-add of its COO entries, each value rounded to
    ``_generic_dtype()`` before the add, as the JAX package's
    ``.astype(dtype)`` does (spmm_dense.py:373-387)."""
    coo = mat.tocoo()
    dtype = _generic_dtype()
    a = dense_dual.pitched_empty(*mat.shape, dtype, device).zero_()
    idx = (torch.as_tensor(coo.row.astype(np.int64), device=device),
           torch.as_tensor(coo.col.astype(np.int64), device=device))
    vals = torch.as_tensor(coo.data.astype(np.float32), device=device).to(dtype)
    return DenseMat(a.index_put_(idx, vals, accumulate=True))


def _mm_f32(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a @ x summed in f32 for operands of one dtype (bf16 or f32), f32
    out. bf16 on the card: cuBLAS with f32 output
    (``torch.mm(..., out_dtype=float32)``) and reduced-precision
    reductions off; on the CPU, which has no kernel for that, the operands
    widened to f32 (each product exact). f32: a full-f32 GEMM, TF32 off."""
    if a.dtype == torch.float32:
        with full_f32_matmul():
            return a @ x
    if a.device.type != "cuda":
        return a.float() @ x.float()
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        return torch.mm(a, x, out_dtype=torch.float32)
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved


class _DenseMatSpmm(torch.autograd.Function):
    """JAX's ``dot(a, x.astype(a.dtype), preferred_element_type=f32)
    .astype(x.dtype)`` and its VJP (spmm_dense.py:348-350). Forward: x
    rounded to the block's dtype, f32 sums, f32 out. Backward: the f32
    cotangent times Aᵀ with f32 sums, then rounded to the block's dtype
    (the gradient of ``x.astype``'s output) and back to f32. For a bf16
    block the f32 cotangent goes in as :func:`dense_dual.split_f32`'s three
    exact bf16 pieces side by side, one GEMM of width 3D, recombined in
    f32; the rounding to bf16 after the sum is what JAX's gradient holds."""

    @staticmethod
    def forward(ctx, x, a):
        ctx.save_for_backward(a)
        ctx.x_dtype = x.dtype
        return _mm_f32(a, x.to(a.dtype)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        g = g.float()
        if a.dtype == torch.float32:
            gx = _mm_f32(a.T, g)
        else:
            d = g.shape[1]
            hi, mid, lo = dense_dual.split_f32(g.contiguous())
            p = _mm_f32(a.T, torch.cat([hi, mid, lo], dim=1))
            gx = (p[:, :d] + p[:, d:2 * d] * 2.0 ** -8) + p[:, 2 * d:] * 2.0 ** -16
        return gx.to(a.dtype).to(ctx.x_dtype), None


def dense_mat_spmm(adj: DenseMat, x: torch.Tensor) -> torch.Tensor:
    """adj @ x with f32 sums; the gradient flows to ``x`` only."""
    return _DenseMatSpmm.apply(x, adj.a)
