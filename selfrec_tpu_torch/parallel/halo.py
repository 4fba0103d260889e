"""Halo-exchange sharded SpMM (counterpart of ``selfrec_tpu/parallel/halo.py``).

Rows of the sources and destinations are block-partitioned over ``model``
(rank ``s`` owns rows ``[s * R, (s + 1) * R)``). The ELL virtual rows are
owned by the model rank of their destination and dealt round-robin over
``data`` within it. Per propagation, rank ``(d, s)``:

1. gathers the rows its model peers asked for (``send_idx``) from its own
   source block;
2. exchanges them in one ``all_to_all`` over ``model``: exactly the unique
   remote rows its slots read (the halo), never the whole table;
3. runs kernel K2 (:func:`selfrec_tpu_torch.ops.ell_gather.ell_gather_sum`)
   over ``[x_loc; halo]`` with the layout of its own virtual rows;
4. sums its partial block over ``data`` (``psum``).

The host plan (:func:`build_halo_plan`) is a numpy copy of the JAX
package's and its arrays equal JAX's; each rank keeps only its ``(d, s)``
slice (:class:`LocalHalo`), with K2's layout built once from it. Pad
virtual rows carry destination ``r_dst`` and weight 0, so K2 runs over
``r_dst + 1`` rows and the last is dropped, as JAX's ``segment_sum(...,
num_segments=r_dst + 1)[:r_dst]`` does.

The layer (:func:`halo_spmm_packed`) takes the full, replicated ``x`` that
every rank holds (the loss is computed on every rank, see
:mod:`selfrec_tpu_torch.parallel.mesh`): it slices the rank's source block,
runs the four steps, and gathers the output blocks over ``model``. Its
backward is the same apply over the transpose plan (halo.py:327-354).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from selfrec_tpu_torch.ops.ell_gather import ell_gather_sum
from selfrec_tpu_torch.ops.precision import compute_dtype
from selfrec_tpu_torch.ops.spmm_ell import EllLayout, layout_from_rows
from selfrec_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_gather,
                                             all_to_all, psum, row_block)


class HaloPlan(NamedTuple):
    """The host plan of every rank for one propagation direction
    (halo.py:44-73); array fields are numpy, stacked (ND, M, ...)."""

    vidx: np.ndarray       # (ND, M, Vmax*K) int32 in [0, R_src + M*H)
    vdst: np.ndarray       # (ND, M, Vmax) int32 local dst row, pad -> R_dst
    slot_edge: np.ndarray  # (ND, M, Vmax*K) int32 original edge id, pad -> E
    send_idx: np.ndarray   # (ND, M, M*H) int32 local src rows for each peer
    n_rows: int
    n_cols: int
    r_dst: int
    r_src: int
    k: int
    h: int
    vmax: int
    n_edges: int


def build_halo_plan(src, dst, n_rows: int, n_cols: int, nd: int, nm: int,
                    k: int = 16) -> HaloPlan:
    """Host-side one-time plan build (halo.py:76-195), numpy."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    e = len(src)
    r_dst = -(-n_rows // nm)
    r_src = -(-n_cols // nm)

    # row-split virtual rows, as spmm_ell.build_ell_layout makes them
    order = np.argsort(dst, kind="stable").astype(np.int32)
    s_dst = dst[order]
    counts = np.bincount(s_dst, minlength=n_rows).astype(np.int32)
    run_starts = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=run_starts[1:])
    within = np.arange(e, dtype=np.int32) - run_starts[s_dst]
    vrows_per_dst = -(-counts // k)
    first_vrow = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(vrows_per_dst, out=first_vrow[1:])
    v = int(first_vrow[-1])
    edge_vrow_sorted = first_vrow[s_dst] + within // k
    edge_slot_sorted = within % k
    nz = np.nonzero(vrows_per_dst)[0]
    vdst_g = np.repeat(nz.astype(np.int32), vrows_per_dst[nz])  # (V,) sorted

    # owner shard by destination block, round-robin over data within it
    owner = vdst_g // r_dst
    v_data = np.empty(v, dtype=np.int32)
    v_local = np.empty(v, dtype=np.int32)
    vmax = 1
    for s in range(nm):
        vs = np.nonzero(owner == s)[0]
        pos = np.arange(len(vs), dtype=np.int32)
        v_data[vs] = pos % nd
        v_local[vs] = pos // nd
        if len(vs):
            vmax = max(vmax, int(-(-len(vs) // nd)))

    # each edge's device coordinates, in the original edge order
    inv = np.empty(e, dtype=np.int32)
    inv[order] = np.arange(e, dtype=np.int32)
    edge_vrow = edge_vrow_sorted[inv]
    edge_slot = edge_slot_sorted[inv]
    e_owner = owner[edge_vrow]
    e_data = v_data[edge_vrow]
    e_local = v_local[edge_vrow]

    vdst_arr = np.full((nd, nm, vmax), r_dst, dtype=np.int32)
    vdst_arr[v_data, owner, v_local] = vdst_g - owner * r_dst
    slot_edge = np.full((nd, nm, vmax, k), e, dtype=np.int32)
    slot_edge[e_data, e_owner, e_local, edge_slot] = np.arange(e, dtype=np.int32)
    vidx_g = np.zeros((nd, nm, vmax, k), dtype=np.int64)
    vidx_g[e_data, e_owner, e_local, edge_slot] = src
    src_owner = np.full((nd, nm, vmax, k), -1, dtype=np.int32)
    src_owner[e_data, e_owner, e_local, edge_slot] = src // r_src

    # the halo: unique remote rows per (device, owning shard)
    uniques = {}
    h = 1
    for d in range(nd):
        for s in range(nm):
            so = src_owner[d, s].ravel()
            sg = vidx_g[d, s].ravel()
            for o in range(nm):
                if o == s:
                    continue
                u = np.unique(sg[so == o])
                uniques[(d, s, o)] = u
                h = max(h, len(u))

    vidx = np.zeros((nd, nm, vmax * k), dtype=np.int32)
    send_idx = np.zeros((nd, nm, nm, h), dtype=np.int32)
    for d in range(nd):
        for s in range(nm):
            so = src_owner[d, s].ravel()
            sg = vidx_g[d, s].ravel()
            out = np.zeros(vmax * k, dtype=np.int32)
            local = so == s
            out[local] = (sg[local] - s * r_src).astype(np.int32)
            for o in range(nm):
                if o == s:
                    continue
                u = uniques[(d, s, o)]
                m = so == o
                if len(u):
                    out[m] = r_src + o * h + np.searchsorted(u, sg[m]).astype(np.int32)
                # device (d, o) serves these requests from its own block
                send_idx[d, o, s, : len(u)] = (u - o * r_src).astype(np.int32)
            vidx[d, s] = out

    return HaloPlan(vidx=vidx, vdst=vdst_arr,
                    slot_edge=slot_edge.reshape(nd, nm, vmax * k),
                    send_idx=send_idx.reshape(nd, nm, nm * h), n_rows=n_rows,
                    n_cols=n_cols, r_dst=r_dst, r_src=r_src, k=k, h=h, vmax=vmax,
                    n_edges=e)


class LocalHalo(NamedTuple):
    """One rank's slice of a :class:`HaloPlan`, on its device: K2's layout
    over its virtual rows (``r_dst + 1`` rows, the last for the pads), the
    original edge of each slot (``n_edges`` for a pad) and the rows it
    sends to each model peer."""

    layout: EllLayout
    slot_edge: torch.Tensor  # (Vmax*K,) int64
    send_idx: torch.Tensor   # (M*H,) int64
    n_rows: int
    n_cols: int
    r_dst: int
    r_src: int
    h: int
    vmax: int
    n_edges: int
    grid: tuple              # (ND, M)

    def comm_bytes(self, n_channels: int, dtype_bytes: int = 4) -> dict:
        """Bytes a rank receives in one call: the halo (``all_to_all``),
        the sum over data (``psum_block``, halo.py:63-68) and the port's
        gather of the output blocks over model (``all_gather_out``)."""
        nd, m = self.grid
        row = n_channels * dtype_bytes
        return {"all_to_all": (m - 1) * self.h * row,
                "psum_block": self.r_dst * row if nd > 1 else 0,
                "all_gather_out": (m - 1) * self.r_dst * row}


def local_plan(plan: HaloPlan, mesh: Mesh, device) -> LocalHalo:
    d, s = mesh.coords

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    layout = layout_from_rows(plan.vidx[d, s], plan.vdst[d, s], plan.r_dst + 1,
                              plan.k, device)
    return LocalHalo(layout=layout, slot_edge=dev(plan.slot_edge[d, s]),
                     send_idx=dev(plan.send_idx[d, s]), n_rows=plan.n_rows,
                     n_cols=plan.n_cols, r_dst=plan.r_dst, r_src=plan.r_src,
                     h=plan.h, vmax=plan.vmax, n_edges=plan.n_edges,
                     grid=tuple(plan.vidx.shape[:2]))


def _halo_apply(loc: LocalHalo, mesh: Mesh, w_pad: torch.Tensor,
                x_loc: torch.Tensor, n_passes: int) -> torch.Tensor:
    """The rank's complete output block (r_dst, P*D) f32 from its source
    block ``x_loc`` (r_src, P*D) and per-pass weights ``w_pad`` (P, E+1),
    0 at index E (halo.py:212-250). Under ``compute.dtype`` bf16 the rows
    and the weights are rounded to bf16, as the single-device ELL path
    rounds them."""
    dt = compute_dtype()
    if dt is not None:
        x_loc = x_loc.to(dt)
        w_pad = w_pad.to(dt)
    halo = all_to_all(x_loc.index_select(0, loc.send_idx), mesh, MODEL_AXIS)
    xfull = torch.cat([x_loc, halo], dim=0)
    k = loc.layout.k
    w = w_pad.index_select(1, loc.slot_edge).to(torch.float32)
    w = w.reshape(n_passes, loc.vmax, k).contiguous()
    out = ell_gather_sum(loc.layout, w, xfull.contiguous())[: loc.r_dst]
    return psum(out, mesh, DATA_AXIS)


def _source_block(x: torch.Tensor, loc: LocalHalo, mesh: Mesh) -> torch.Tensor:
    """This rank's source block of the full ``x``, zero rows past its end."""
    nm = mesh.shape[MODEL_AXIS]
    pad = nm * loc.r_src - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    return row_block(x, mesh)


def _propagate(loc: LocalHalo, mesh: Mesh, w_pad, x, n_passes):
    """Full ``x`` in, full output (n_rows, P*D) f32 out, on every rank."""
    out = _halo_apply(loc, mesh, w_pad, _source_block(x, loc, mesh), n_passes)
    return all_gather(out, mesh, MODEL_AXIS)[: loc.n_rows]


class HaloAdj:
    """Sharded adjacency: this rank's forward and transpose plans and the
    per-edge weights in the original edge order. ``reweight`` makes a view
    over the same plans (SGL's and SEPT's dropped views, BUIR's per-step
    dropout), as :class:`selfrec_tpu_torch.ops.spmm_ell.EllAdj`'s does."""

    def __init__(self, fwd: LocalHalo, bwd: LocalHalo, edge_w: torch.Tensor, mesh: Mesh):
        self.fwd = fwd
        self.bwd = bwd
        self.edge_w = edge_w
        self.mesh = mesh

    def reweight(self, edge_w: torch.Tensor) -> "HaloAdj":
        return HaloAdj(self.fwd, self.bwd, edge_w, self.mesh)

    def comm_bytes(self, n_channels: int) -> dict:
        return {"fwd": self.fwd.comm_bytes(n_channels),
                "bwd": self.bwd.comm_bytes(n_channels)}

    def __repr__(self):
        return (f"HaloAdj(E={self.fwd.n_edges}, Vmax={self.fwd.vmax}, "
                f"K={self.fwd.layout.k}, H={self.fwd.h})")


def build_halo_adj(src, dst, w, n_rows: int, n_cols: int, mesh: Mesh, k: int = 16,
                   device="cuda") -> HaloAdj:
    nd, nm = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    fwd = local_plan(build_halo_plan(src, dst, n_rows, n_cols, nd, nm, k), mesh, device)
    bwd = local_plan(build_halo_plan(dst, src, n_cols, n_rows, nd, nm, k), mesh, device)
    return HaloAdj(fwd, bwd, torch.as_tensor(np.asarray(w, dtype=np.float32),
                                             device=device), mesh)


def halo_from_ell(ell, mesh: Mesh) -> HaloAdj:
    """A HaloAdj over the edges of an EllAdj (halo.py:291-298): the
    single-device layout carries the original edge list."""
    slots = ell.fwd.edge_slots.cpu().numpy()
    src = ell.fwd.vidx.cpu().numpy()[slots]
    dst = ell.fwd.vdst.cpu().numpy()[slots // ell.fwd.k]
    return build_halo_adj(src, dst, ell.edge_w.cpu().numpy(), ell.fwd.n_rows,
                          ell.bwd.n_rows, mesh, k=ell.fwd.k, device=ell.edge_w.device)


def _w_pad(edge_w: torch.Tensor) -> torch.Tensor:
    """(P, E) or (E,) weights -> (P, E+1) with the pad slot zeroed."""
    if edge_w.dim() == 1:
        edge_w = edge_w[None]
    return torch.nn.functional.pad(edge_w, (0, 1))


class _HaloSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_edge_stack, adj, n_passes):
        ctx.adj = adj
        ctx.n_passes = n_passes
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(w_edge_stack)
        return _propagate(adj.fwd, adj.mesh, _w_pad(w_edge_stack), x, n_passes)

    @staticmethod
    def backward(ctx, g):
        (w_edge_stack,) = ctx.saved_tensors
        adj = ctx.adj
        dx = _propagate(adj.bwd, adj.mesh, _w_pad(w_edge_stack), g.contiguous(),
                        ctx.n_passes)
        dw = torch.zeros_like(w_edge_stack) if ctx.needs_input_grad[1] else None
        return dx.to(ctx.x_dtype), dw, None, None


def halo_spmm_packed(adj: HaloAdj, w_edge_stack: torch.Tensor, x: torch.Tensor,
                     n_passes: int) -> torch.Tensor:
    """P-pass packed sharded SpMM (the HaloAdj counterpart of
    ``ell_spmm_packed``): ``x`` (n_cols, P*D) full on every rank,
    ``w_edge_stack`` (P, E) per-pass weights in the original edge order.
    One K2 launch a rank a call; the gradient flows to ``x`` only."""
    if w_edge_stack.dim() != 2 or w_edge_stack.shape[0] != n_passes:
        raise ValueError(f"w_edge_stack {tuple(w_edge_stack.shape)} is not "
                         f"({n_passes}, E)")
    return _HaloSpmm.apply(x, w_edge_stack, adj, n_passes)


def halo_spmm(adj: HaloAdj, x: torch.Tensor) -> torch.Tensor:
    """out[d] = sum over edges e with dst[e] = d of w[e] * x[src[e]]."""
    return _HaloSpmm.apply(x, adj.edge_w[None], adj, 1)
