"""Row-split ELL SpMM (counterpart of ``selfrec_tpu/ops/spmm_ell.py``).

Destinations' neighbour lists (sorted by destination) are cut into virtual
rows of at most K source slots, padded to exactly K (pad slot -> source 0
with weight 0). One propagation is a weighted gather per virtual row plus
a sum over each destination's contiguous virtual rows: kernel K2
(:mod:`selfrec_tpu_torch.ops.ell_gather`). The backward of A @ x is
Aᵀ @ g, so the autograd functions run the SAME kernel over the
precomputed transpose layout; no scatter ever appears.

Weights are a separate input, so reweighted adjacencies (SGL's per-epoch
dropped views) reuse the static layout: ``edge_slots`` maps original edge
order -> flat slot, and new weights are one scatter of E scalars. A packed
propagation takes both directions' slot weights (:class:`SlotWeights`),
built once for as long as its edge weights hold (SGL: once an epoch), or
a (P, E) stack that the call scatters (BUIR's per-step draws).
Weight gradients are zero: adjacency weights are graph constants.

The layout is built on the host with numpy, identical to the JAX
package's (same ``vidx``, ``vdst``, ``edge_slots``), and adds what K2
reads: the row pointer over virtual rows and the rows' work items
(:func:`row_work`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from selfrec_tpu_torch.ops.ell_gather import ell_gather_sum
from selfrec_tpu_torch.ops.precision import compute_dtype

# Virtual rows per K2 work item. On the yelp2018-scale graph 95.3% of the
# destination rows own at most 8 virtual rows (69.0% of V): each of them is
# one item that writes its output row directly. The 4.7% longer rows (up to
# 1,093 virtual rows) are cut into items of 8 whose partials a second pass
# adds in order, so no item does more than 8 virtual rows of gathers.
ROW_CHUNK = 8


class EllLayout(NamedTuple):
    """Static gather layout for one propagation direction."""

    vidx: torch.Tensor        # (V*K,) int32 source ids, pad -> 0
    vdst: torch.Tensor        # (V,) int32 destination row per virtual row, sorted
    n_rows: int
    k: int
    edge_slots: torch.Tensor  # (E,) int32 flat position of edge e in vidx/w
    row_ptr: torch.Tensor     # (n_rows + 1,) int32: row r owns virtual rows
                              # [row_ptr[r], row_ptr[r + 1])
    n_src: int                # 1 + the largest source id (0 without edges)
    item_ptr: torch.Tensor    # (n_items + 1,) int32: item t sums virtual rows
                              # [item_ptr[t], item_ptr[t + 1]); items tile [0, V)
    item_dst: torch.Tensor    # (n_items,) int32: the row it writes, or ~j for
                              # slot j of the long rows' partials
    long_rows: torch.Tensor   # (n_long,) int32 rows longer than ROW_CHUNK
    long_ptr: torch.Tensor    # (n_long + 1,) int32: long row t adds partial
                              # slots [long_ptr[t], long_ptr[t + 1])
    scratch: dict             # K2's partial buffers, one per row width, made
                              # at the first call and kept with the layout


def row_work(row_ptr: np.ndarray):
    """K2's work items over a row pointer (host, one-time).

    A row with at most ``ROW_CHUNK`` virtual rows is one item that writes
    the row; a longer row is ``ceil(n / ROW_CHUNK)`` items of that many
    (the last shorter) that write partial slots, numbered in item order.
    Items are listed in row order, so together they cover every virtual row
    once and in order. Returns (item_ptr, item_dst, long_rows, long_ptr) as
    int32 arrays; rows without virtual rows get an empty item (a zero row)."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    n_rows = len(row_ptr) - 1
    nv = np.diff(row_ptr)
    long = nv > ROW_CHUNK
    per_row = np.where(long, -(-nv // ROW_CHUNK), 1)
    first = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(per_row, out=first[1:])
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), per_row)
    begin = row_ptr[row_of] + (np.arange(first[-1]) - first[row_of]) * ROW_CHUNK
    item_ptr = np.append(begin, row_ptr[-1])
    is_long = long[row_of]
    slot = np.cumsum(is_long) - 1
    item_dst = np.where(is_long, ~slot, row_of)
    long_rows = np.nonzero(long)[0]
    long_ptr = np.zeros(len(long_rows) + 1, dtype=np.int64)
    np.cumsum(per_row[long_rows], out=long_ptr[1:])
    return tuple(a.astype(np.int32) for a in (item_ptr, item_dst, long_rows, long_ptr))


def build_ell_layout(src: np.ndarray, dst: np.ndarray, n_rows: int, k: int = 32,
                     device="cuda") -> Tuple[EllLayout, np.ndarray]:
    """Host-side one-time layout build (spmm_ell.py:58-107), placed on
    ``device``. Returns (layout, slot_order): ``slot_order`` is the stable
    sort of the edges by destination that defines slot order."""
    e = len(src)
    order = np.argsort(dst, kind="stable").astype(np.int32)
    s_src = np.ascontiguousarray(np.asarray(src, dtype=np.int32)[order])
    s_dst = np.ascontiguousarray(np.asarray(dst, dtype=np.int32)[order])
    counts = np.bincount(s_dst, minlength=n_rows).astype(np.int32)
    if len(counts) > n_rows:
        raise ValueError(f"destination {len(counts) - 1} >= n_rows {n_rows}")
    run_starts = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=run_starts[1:])
    within = np.arange(e, dtype=np.int32) - run_starts[s_dst]
    vrows_per_dst = -(-counts // k)
    first_vrow = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(vrows_per_dst, out=first_vrow[1:])
    v = int(first_vrow[-1])
    if v * k >= 2**31:
        raise ValueError(f"ELL slot space {v * k} exceeds int32; lower k or shard")
    vrow = first_vrow[s_dst] + within // k
    flat = vrow * k + within % k

    vidx = np.zeros(v * k, dtype=np.int32)
    vidx[flat] = s_src
    nz = np.nonzero(vrows_per_dst)[0]
    vdst = np.repeat(nz.astype(np.int32), vrows_per_dst[nz])
    edge_slots = np.empty(e, dtype=np.int32)
    edge_slots[order] = flat
    layout = layout_from_rows(vidx, vdst, n_rows, k, device)
    layout = layout._replace(edge_slots=torch.as_tensor(edge_slots, device=device))
    return layout, order


def layout_from_rows(vidx: np.ndarray, vdst: np.ndarray, n_rows: int, k: int,
                     device="cuda") -> EllLayout:
    """The layout K2 reads over given virtual rows: ``vidx`` (V*K,) source
    ids, ``vdst`` (V,) their destination rows, non-decreasing, each below
    ``n_rows``. Its ``edge_slots`` is empty: the caller that knows the
    edges sets it (:func:`build_ell_layout`) or weights the slots itself
    (the halo exchange's per-rank layouts)."""
    vidx = np.ascontiguousarray(vidx, dtype=np.int32)
    vdst = np.ascontiguousarray(vdst, dtype=np.int32)
    row_ptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(np.bincount(vdst, minlength=n_rows), out=row_ptr[1:])

    def dev(a):
        return torch.as_tensor(a, device=device)

    item_ptr, item_dst, long_rows, long_ptr = row_work(row_ptr)
    return EllLayout(vidx=dev(vidx), vdst=dev(vdst), n_rows=n_rows, k=k,
                     edge_slots=dev(np.zeros(0, np.int32)), row_ptr=dev(row_ptr),
                     n_src=int(vidx.max()) + 1 if len(vidx) else 0,
                     item_ptr=dev(item_ptr), item_dst=dev(item_dst),
                     long_rows=dev(long_rows), long_ptr=dev(long_ptr), scratch={})


def ell_weights(layout: EllLayout, edge_w: torch.Tensor) -> torch.Tensor:
    """(..., V, K) weights from per-edge weights (..., E) in ORIGINAL edge
    order: (E,) gives (V, K), a (P, E) stack gives (P, V, K)."""
    v, k = layout.vdst.shape[0], layout.k
    lead = tuple(edge_w.shape[:-1])
    flat = torch.zeros(lead + (v * k,), dtype=edge_w.dtype, device=edge_w.device)
    flat[..., layout.edge_slots] = edge_w
    return flat.reshape(lead + (v, k))


class EllAdj:
    """Bidirectional ELL adjacency: forward layout + transpose layout with
    their weight matrices, plus the per-edge weights in original edge order
    (for reweighting). Propagated by :func:`ell_spmm`."""

    def __init__(self, fwd: EllLayout, w_fwd, bwd: EllLayout, w_bwd, edge_w):
        self.fwd = fwd
        self.w_fwd = w_fwd
        self.bwd = bwd
        self.w_bwd = w_bwd
        self.edge_w = edge_w

    def reweight(self, edge_w: torch.Tensor) -> "EllAdj":
        """New EllAdj with per-edge weights replaced (original edge order);
        the static layouts are reused."""
        return EllAdj(self.fwd, ell_weights(self.fwd, edge_w),
                      self.bwd, ell_weights(self.bwd, edge_w), edge_w)

    def __repr__(self):
        return (f"EllAdj(V={self.fwd.vdst.shape[0]}, K={self.fwd.k},"
                f" n_rows={self.fwd.n_rows})")


def ell_adj_from_edges(src, dst, w, n_rows: int, n_cols: int = None, k: int = 32,
                       device="cuda") -> EllAdj:
    """Build both directions from an edge list (host, one-time) on
    ``device``. For a square adjacency n_cols defaults to n_rows."""
    n_cols = n_rows if n_cols is None else n_cols
    fwd, _ = build_ell_layout(np.asarray(src), np.asarray(dst), n_rows, k, device)
    bwd, _ = build_ell_layout(np.asarray(dst), np.asarray(src), n_cols, k, device)
    w = torch.as_tensor(np.asarray(w, dtype=np.float32), device=device)
    return EllAdj(fwd, ell_weights(fwd, w), bwd, ell_weights(bwd, w), w)


def _apply(layout: EllLayout, w_stack: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K2 over ``layout`` with weights (P, V, K) in the compute dtype
    (spmm_ell.py:169-189, 286-297): under bf16 both the rows and the
    weights are rounded to bf16; their products are exact in f32."""
    dt = compute_dtype()
    if dt is not None:
        x = x.to(dt)
        w_stack = w_stack.to(dt).to(torch.float32)
    return ell_gather_sum(layout, w_stack.contiguous(), x.contiguous())


class _EllSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return _apply(adj.fwd, adj.w_fwd[None], x)

    @staticmethod
    def backward(ctx, g):
        return _apply(ctx.adj.bwd, ctx.adj.w_bwd[None], g), None


def ell_spmm(adj: EllAdj, x: torch.Tensor) -> torch.Tensor:
    """out[d] = Σ_{e: dst[e]=d} w[e] * x[src[e]] (spmm_ell.py:250-273); the
    backward is K2 over the transpose layout, and the weights get none."""
    return _EllSpmm.apply(x, adj)


class SlotWeights(NamedTuple):
    """A packed propagation's slot weights over both layouts of an
    :class:`EllAdj`: (P, V, K) over ``fwd`` and (P, V', K) over ``bwd``."""

    fwd: torch.Tensor
    bwd: torch.Tensor


def packed_slot_weights(adj: EllAdj, w_edge_stack: torch.Tensor) -> SlotWeights:
    """Both layouts' (P, V, K) slot weights from per-pass edge weights
    (P, E) in ORIGINAL edge order: two scatters. Weights held fixed (SGL's
    three chains over an epoch) are built once and passed to every
    :func:`ell_spmm_packed`."""
    return SlotWeights(ell_weights(adj.fwd, w_edge_stack), ell_weights(adj.bwd, w_edge_stack))


class _EllSpmmPacked(torch.autograd.Function):
    """K2 over ``adj.fwd`` with the (P, V, K) ``w_fwd``; its backward K2
    over ``adj.bwd`` with ``w_bwd``: the (P, V', K) block, or the (P, E)
    edge weights that the backward scatters into it."""

    @staticmethod
    def forward(ctx, x, w_fwd, w_bwd, adj):
        ctx.adj = adj
        ctx.fwd_shape = w_fwd.shape
        ctx.save_for_backward(w_bwd)
        return _apply(adj.fwd, w_fwd, x)

    @staticmethod
    def backward(ctx, g):
        (w_bwd,) = ctx.saved_tensors
        slots = w_bwd if w_bwd.dim() == 3 else ell_weights(ctx.adj.bwd, w_bwd)
        dx = _apply(ctx.adj.bwd, slots, g)
        # weights are graph constants: weights that ask get zeros
        need_fwd, need_bwd = ctx.needs_input_grad[1:3]
        dw_fwd = w_bwd.new_zeros(ctx.fwd_shape) if need_fwd else None
        dw_bwd = torch.zeros_like(w_bwd) if need_bwd else None
        return dx, dw_fwd, dw_bwd, None


def ell_spmm_packed(adj: EllAdj, w, x: torch.Tensor, n_passes: int) -> torch.Tensor:
    """P-pass packed SpMM over one shared layout (spmm_ell.py:303-332).

    ``w`` is the passes' :class:`SlotWeights` built beforehand
    (:func:`packed_slot_weights`), read as they are, or their (P, E) edge
    weights in ORIGINAL edge order (the template's), which the call
    scatters: the forward block in the forward, the backward block in the
    backward from the stack it saves; ``x``
    (n, P*D). One K2 launch covers all P passes. The gradient flows to
    ``x`` only (weights are graph constants)."""
    if isinstance(w, torch.Tensor):
        if w.dim() != 2 or w.shape[0] != n_passes:
            raise ValueError(f"w_edge_stack {tuple(w.shape)} is not ({n_passes}, E)")
        return _EllSpmmPacked.apply(x, ell_weights(adj.fwd, w.detach()), w, adj)
    if w.fwd.shape[0] != n_passes or w.bwd.shape[0] != n_passes:
        raise ValueError(f"slot weights {tuple(w.fwd.shape)} / {tuple(w.bwd.shape)} "
                         f"do not hold {n_passes} passes")
    return _EllSpmmPacked.apply(x, w.fwd, w.bwd, adj)
