"""Sharded dense-bipartite propagation (counterpart of
``selfrec_tpu/parallel/dense_shard.py``).

The (U, I) incidence is 2-D partitioned over the whole (data, model) grid:
the padded item axis is cut into ``model`` blocks (as the item table is)
and each of those into ``data`` sub-blocks, so rank ``(d, s)`` holds the
(U_pad, i_blk) column slice B_{d,s}, built on its device from its edges
(:func:`dense_plan`, a numpy copy of the JAX package's host plan), and its
kept transpose, which kernel K1 reads for the item direction. One copy of
B over the grid: the dense budget grows with the device count.

One propagation (:func:`sharded_dense_spmm`) is one K1 launch a rank:

    pu, pi = (B_{d,s} @ xi_loc, B_{d,s}ᵀ @ xu_full)
    out_u  = psum over data of (psum_scatter over model of pu)
    out_i  = all_gather over data of pi

The layer takes the full, replicated ``x`` every rank holds (the loss is
computed on every rank), so ``xu_full`` is at hand and the JAX package's
first ``all_gather`` of the user rows over ``model`` has no counterpart
here; instead the model-sharded outputs are gathered over ``model`` at
the end. In the int8 mode each rank quantizes its LOCAL operands per
channel (``xi_loc`` and ``xu_full``, as dense_shard.py:310-328 does) and
dequantizes each product with its own scales before the sums; the
single-device path's global scales do not apply. The bf16 and f32 modes
run K1's float kernel with f32 sums, as :class:`DenseAdj` does.

The unified Laplacian is symmetric, so the backward is the same apply on
the cotangent (dense_shard.py:379-401): no transpose plan.

:class:`ShardedDenseMat` (dense_shard.py:404-510) row-shards a static
dense matrix (MHCN's channels, SEPT's views) over the whole grid: the
forward is the local rows' GEMM and an all-gather over the grid, the
backward the local ``a_blkᵀ @ g_blk`` summed over the grid.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from selfrec_tpu_torch.ops import dense_dual
from selfrec_tpu_torch.ops.spmm_dense import (_dense_dtype, _generic_products, _mm_f32,
                                              _quant_per_channel, _try_factor,
                                              _zero_block, mat_t_f32)
from selfrec_tpu_torch.parallel.mesh import (DATA_AXIS, GRID, MODEL_AXIS, Mesh,
                                             all_gather, psum, psum_scatter, row_block)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


class DensePlan(NamedTuple):
    """The host plan of every rank (dense_shard.py:201-236): each rank's
    padded edges, stacked (ND * M, Emax), pads at (0, 0) with edge id E."""

    u_pad: int
    i_pad: int
    i_blk: int
    eu_dev: np.ndarray   # user row
    ei_dev: np.ndarray   # LOCAL column
    eid_dev: np.ndarray  # original edge id


def dense_plan(edge_users, edge_items, n_users: int, n_items: int, nd: int,
               nm: int) -> DensePlan:
    eu = np.asarray(edge_users, dtype=np.int32)
    ei = np.asarray(edge_items, dtype=np.int32)
    e = len(eu)
    u_pad = _ceil_to(max(n_users, nm), nm)
    i_pad = _ceil_to(max(n_items, nd * nm), nd * nm)
    i_blk = i_pad // (nd * nm)

    s_of = ei // (i_pad // nm)
    d_of = (ei % (i_pad // nm)) // i_blk
    dev = d_of.astype(np.int64) * nm + s_of
    order = np.argsort(dev, kind="stable")
    counts = np.bincount(dev, minlength=nd * nm)
    e_max = max(int(counts.max()), 1)
    starts = np.zeros(nd * nm + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(e, dtype=np.int64) - starts[dev[order]]

    eu_dev = np.zeros((nd * nm, e_max), dtype=np.int32)
    ei_dev = np.zeros((nd * nm, e_max), dtype=np.int32)
    eid_dev = np.full((nd * nm, e_max), e, dtype=np.int32)
    eu_dev[dev[order], within] = eu[order]
    ei_dev[dev[order], within] = (ei % (i_pad // nm))[order] % i_blk
    eid_dev[dev[order], within] = order.astype(np.int32)
    return DensePlan(u_pad, i_pad, i_blk, eu_dev, ei_dev, eid_dev)


class LocalEdges(NamedTuple):
    """One rank's padded edges on its device and its slice's shape."""

    eu: torch.Tensor   # (Emax,) int64 user row, pad 0
    ei: torch.Tensor   # (Emax,) int64 local column, pad 0
    eid: torch.Tensor  # (Emax,) int64 original edge id, pad E
    u_pad: int
    i_blk: int

    def scatter(self, vals: torch.Tensor, dtype) -> torch.Tensor:
        """The (U_pad, i_blk) slice with ``vals`` (E+1,), 0 at index E,
        added at the edges' positions; an int8 slice has K1's row pitch."""
        if dtype == torch.int8:
            b = _zero_block(self.u_pad, self.i_blk, vals.device)
        else:
            b = torch.zeros((self.u_pad, self.i_blk), dtype=dtype, device=vals.device)
        return b.index_put_((self.eu, self.ei), vals.to(dtype)[self.eid], accumulate=True)


class ShardedDenseAdj:
    """Mesh-sharded dense-bipartite adjacency, this rank's part
    (dense_shard.py:59-190).

    ``b`` is the rank's (U_pad, i_blk) column slice: in the factored mode
    the binary int8 incidence with exact f32 diagonal scalings (``bt`` its
    kept transpose, for K1), in the generic mode arbitrary edge values in a
    float dtype (no transpose). ``local`` holds the rank's padded edges, so
    that dropped views rebuild the slice locally."""

    def __init__(self, b, bt, local: LocalEdges, edge_users, edge_items, edge_w,
                 row_scale, col_scale, gain, n_users: int, n_items: int, i_pad: int,
                 mesh: Mesh, mm_dtype=torch.bfloat16):
        self.b = b
        self.bt = bt
        self.local = local
        self.edge_users = edge_users
        self.edge_items = edge_items
        self.edge_w = edge_w
        self.row_scale = row_scale
        self.col_scale = col_scale
        self.gain = gain
        self.n_users = n_users
        self.n_items = n_items
        self.n_nodes = n_users + n_items
        self.u_pad = local.u_pad
        self.i_pad = i_pad
        self.i_blk = local.i_blk
        self.mesh = mesh
        self.mm_dtype = mm_dtype

    @property
    def factored(self) -> bool:
        return self.row_scale is not None

    @property
    def grid(self):
        return self.mesh.shape[DATA_AXIS], self.mesh.shape[MODEL_AXIS]

    def _like(self, b, bt, edge_w, row_scale, col_scale, gain, mm_dtype):
        return ShardedDenseAdj(b, bt, self.local, self.edge_users, self.edge_items,
                               edge_w, row_scale, col_scale, gain, self.n_users,
                               self.n_items, self.i_pad, self.mesh, mm_dtype)

    def reweight(self, w: torch.Tensor) -> "ShardedDenseAdj":
        """A generic view with per-edge weights ``w`` (original edge order),
        rebuilt by one local scatter; never int8: the int8 mode takes bf16
        here (dense_shard.py:121-137)."""
        dtype = torch.bfloat16 if self.mm_dtype == torch.int8 else self.mm_dtype
        b = self.local.scatter(torch.nn.functional.pad(w.to(dtype), (0, 1)), dtype)
        return self._like(b, None, w, None, None, None, dtype)

    def refactor_view(self, keep: torch.Tensor) -> "ShardedDenseAdj":
        """The symmetric-renormalized dropped view that stays int8-factored
        (dense_shard.py:139-162): a new binary slice and new diagonal
        scalings over the kept degrees. ``keep`` is (E,) bool in this
        adjacency's edge order."""
        kf = keep.to(torch.float32)
        du = torch.zeros(self.n_users, dtype=torch.float32, device=kf.device)
        di = torch.zeros(self.n_items, dtype=torch.float32, device=kf.device)
        du.index_add_(0, self.edge_users, kf)
        di.index_add_(0, self.edge_items, kf)
        ru = torch.where(du > 0, torch.rsqrt(torch.clamp(du, min=1e-12)), 0.0)
        ci = torch.where(di > 0, torch.rsqrt(torch.clamp(di, min=1e-12)), 0.0)
        b = self.local.scatter(torch.nn.functional.pad(keep.to(torch.int8), (0, 1)),
                               torch.int8)
        w = kf * ru[self.edge_users] * ci[self.edge_items]
        return self._like(b, dense_dual.block_transpose(b), w, ru, ci,
                          torch.tensor(1.0, dtype=torch.float32, device=kf.device),
                          self.mm_dtype)

    def comm_bytes(self, n_channels: int, dtype_bytes: int = 4) -> dict:
        """Bytes a rank receives in one call (ring algorithms): the sums of
        the user partials over model and data and the gathers of the item
        partials over data (dense_shard.py:164-174), and, in place of the
        JAX package's gather of the user rows, the port's gathers of both
        outputs over model."""
        nd, nm = self.grid
        up, ipm = self.u_pad, self.i_pad // nm
        row = n_channels * dtype_bytes
        return {
            "psum_scatter_model": up * row * (nm - 1) // nm,
            "psum_data": 2 * (up // nm) * row * (nd - 1) // nd,
            "all_gather_model": (up + self.i_pad) * row * (nm - 1) // nm,
            "all_gather_data": ipm * row * (nd - 1) // nd,
        }

    def __repr__(self):
        nd, nm = self.grid
        mode = "int8-factored" if self.factored else str(self.b.dtype)
        gb = self.b.numel() * self.b.element_size() / 1e9
        return (f"ShardedDenseAdj(U={self.n_users}, I={self.n_items}, "
                f"grid=({nd},{nm}), {mode}, {gb:.3f} GB/rank)")


def build_sharded_dense(edge_users, edge_items, w, n_users: int, n_items: int,
                        mesh: Mesh, device="cuda") -> ShardedDenseAdj:
    """The rank's part from the edges (dense_shard.py:201-275): the host
    plan, then the rank's slice scattered on ``device``. Symmetric-normalized
    (or constant) weights give the factored int8 form; others a generic
    block (bf16 under the int8 mode)."""
    nd, nm = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    plan = dense_plan(edge_users, edge_items, n_users, n_items, nd, nm)
    r = mesh.rank

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    w_np = np.asarray(w, dtype=np.float32)
    edge_w = torch.as_tensor(w_np, device=device)
    fac = _try_factor(edge_users, edge_items, w_np, n_users, n_items)
    mm_dtype = _dense_dtype()
    if mm_dtype == torch.int8 and fac is None:
        mm_dtype = torch.bfloat16
    local = LocalEdges(dev(plan.eu_dev[r]), dev(plan.ei_dev[r]), dev(plan.eid_dev[r]),
                       plan.u_pad, plan.i_blk)

    def part(b, bt, scales, dtype):
        return ShardedDenseAdj(b, bt, local, dev(edge_users), dev(edge_items), edge_w,
                               *scales, n_users, n_items, plan.i_pad, mesh, dtype)

    if fac is None:
        b = local.scatter(torch.nn.functional.pad(edge_w, (0, 1)), mm_dtype)
        return part(b, None, (None, None, None), mm_dtype)
    ru, ci, gain = fac
    ones = torch.ones(len(w_np) + 1, dtype=torch.int8, device=device)
    ones[-1] = 0
    b = local.scatter(ones, torch.int8)
    return part(b, dense_dual.block_transpose(b),
                (torch.as_tensor(ru, device=device), torch.as_tensor(ci, device=device),
                 torch.tensor(gain, dtype=torch.float32, device=device)), mm_dtype)


def sharded_dense_from_dense(adj, mesh: Mesh) -> ShardedDenseAdj:
    """A single-device DenseAdj (which keeps its edges) rebuilt sharded."""
    return build_sharded_dense(adj.edge_users.cpu().numpy(), adj.edge_items.cpu().numpy(),
                               adj.edge_w.cpu().numpy(), adj.n_users, adj.n_items, mesh,
                               device=adj.device)


def fits_sharded_dense(n_users: int, n_items: int, mesh: Mesh) -> bool:
    """The per-rank budget gate (dense_shard.py:285-299): one column slice
    against ``SELFREC_TPU_DENSE_BUDGET_GB``, so the dense capacity grows
    with the device count."""
    nd, nm = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    u_pad = _ceil_to(max(n_users, nm), nm)
    i_pad = _ceil_to(max(n_items, nd * nm), nd * nm)
    per_dev = u_pad * (i_pad // (nd * nm))
    budget_gb = float(os.environ.get("SELFREC_TPU_DENSE_BUDGET_GB", "5"))
    itemsize = torch.empty((), dtype=_dense_dtype()).element_size()
    return per_dev * itemsize <= budget_gb * 1e9


def local_quantized(xu_full: torch.Tensor, xi_loc: torch.Tensor):
    """The int8 mode's operands of one rank: (zq, zs) of ``xu_full`` and
    (yq, ys) of ``xi_loc``, each quantized per channel over its own rows."""
    return _quant_per_channel(xu_full), _quant_per_channel(xi_loc)


def local_products(adj: ShardedDenseAdj, xu_full: torch.Tensor, xi_loc: torch.Tensor):
    """(B_loc @ xi_loc, B_locᵀ @ xu_full) in f32, one K1 launch for a
    factored block: the int8 kernel on the locally quantized operands,
    dequantized with their own scales, or the float kernel on operands
    rounded to the matmul dtype. A generic block multiplies in f32
    (``torch.matmul``, as :class:`DenseAdj` does)."""
    if not adj.factored:
        return _generic_products(adj.b, xu_full, xi_loc)
    if adj.mm_dtype == torch.int8:
        (zq, zs), (yq, ys) = local_quantized(xu_full, xi_loc)
        ou, oi = dense_dual.dual_matmul(adj.b, zq, yq, adj.bt)
        return ou.to(torch.float32) * ys, oi.to(torch.float32) * zs
    mmd = adj.mm_dtype
    return dense_dual.float_products(adj.b, adj.bt, xu_full.to(mmd), xi_loc.to(mmd))


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    pad = n - x.shape[0]
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad else x


def local_operands(adj: ShardedDenseAdj, x: torch.Tensor):
    """(xu_full, xi_loc): the scaled, padded user rows and this rank's
    i_blk item rows of the full ``x`` ((U+I), D)."""
    xu = x[: adj.n_users].to(torch.float32)
    xi = x[adj.n_users:].to(torch.float32)
    if adj.factored:
        xu = xu * (adj.row_scale[:, None] * adj.gain)
        xi = xi * adj.col_scale[:, None]
    d, s = adj.mesh.coords
    start = s * (adj.i_pad // adj.grid[1]) + d * adj.i_blk
    return _pad_rows(xu, adj.u_pad), _pad_rows(xi, adj.i_pad)[start: start + adj.i_blk]


def _apply(adj: ShardedDenseAdj, x: torch.Tensor) -> torch.Tensor:
    """[A @ x_i ; Aᵀ @ x_u] over the unified node space, full ``x`` in and
    full result out on every rank (dense_shard.py:356-376)."""
    mesh = adj.mesh
    pu, pi = local_products(adj, *local_operands(adj, x))
    out_u = psum(psum_scatter(pu, mesh, MODEL_AXIS), mesh, DATA_AXIS)
    out_i = all_gather(pi, mesh, DATA_AXIS)
    out_u = all_gather(out_u, mesh, MODEL_AXIS)[: adj.n_users]
    out_i = all_gather(out_i, mesh, MODEL_AXIS)[: adj.n_items]
    if adj.factored:
        out_u = out_u * (adj.row_scale[:, None] * adj.gain)
        out_i = out_i * adj.col_scale[:, None]
    return torch.cat([out_u, out_i], dim=0).to(x.dtype)


class _ShardedDenseSpmm(torch.autograd.Function):
    """The symmetric-reuse VJP: the backward is the forward apply on the
    cotangent, straight-through in the int8 mode."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return _apply(adj, x)

    @staticmethod
    def backward(ctx, g):
        return _apply(ctx.adj, g.contiguous()), None


def sharded_dense_spmm(adj: ShardedDenseAdj, x: torch.Tensor) -> torch.Tensor:
    return _ShardedDenseSpmm.apply(x, adj)


# -- a static dense matrix under the mesh -----------------------------------------

class ShardedDenseMat:
    """A static dense (M, N) matrix row-sharded over the whole grid
    (dense_shard.py:404-447): ``a`` is this rank's row block (rows padded
    to a multiple of the grid size), in the dtype of the
    :class:`~selfrec_tpu_torch.ops.spmm_dense.DenseMat` it came from."""

    def __init__(self, a: torch.Tensor, n_rows: int, mesh: Mesh):
        self.a = dense_dual._pitched(a)
        self.n_rows = n_rows
        self.n_nodes = n_rows
        self.mesh = mesh

    @property
    def shape(self):
        return (self.n_rows, self.a.shape[1])

    def __repr__(self):
        return (f"ShardedDenseMat({self.n_rows}x{self.a.shape[1]}, {self.a.dtype}, "
                f"{self.mesh.size} ranks)")


def shard_dense_mat(dm, mesh: Mesh) -> ShardedDenseMat:
    """This rank's row block of a DenseMat's block (dense_shard.py:450-463)."""
    m = dm.a.shape[0]
    a = _pad_rows(dm.a, _ceil_to(max(m, mesh.size), mesh.size))
    return ShardedDenseMat(row_block(a, mesh, GRID).clone(), m, mesh)


class _ShardedDenseMatSpmm(torch.autograd.Function):
    """Forward: the local rows' GEMM of ``x`` rounded to the block's dtype,
    f32 sums, then an all-gather over the grid (dense_shard.py:466-477).
    Backward: ``a_blkᵀ @ g_blk`` over the rank's rows in f32, summed over
    the grid, not rounded to the block's dtype (dense_shard.py:487-505)."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        ctx.x_dtype = x.dtype
        out = all_gather(_mm_f32(adj.a, x.to(adj.a.dtype)), adj.mesh, GRID)
        return out[: adj.n_rows].to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        g_blk = row_block(_pad_rows(g.float(), adj.a.shape[0] * adj.mesh.size),
                          adj.mesh, GRID)
        return psum(mat_t_f32(adj.a, g_blk), adj.mesh, GRID).to(ctx.x_dtype), None


def sharded_dense_mat_spmm(adj: ShardedDenseMat, x: torch.Tensor) -> torch.Tensor:
    return _ShardedDenseMatSpmm.apply(x, adj)
