"""Graph propagation ops (counterpart of ``selfrec_tpu/ops/graph.py``).

:func:`spmm` dispatches on the adjacency's layout: the dense-bipartite
block (:mod:`selfrec_tpu_torch.ops.spmm_dense`, kernel K1), the row-split
ELL layout (:mod:`selfrec_tpu_torch.ops.spmm_ell`, kernel K2) or the
edge-list :class:`NormAdj` (a gather and a segment sum in plain torch, as
the JAX package computes it in XLA), or a static dense matrix of any
values (:class:`selfrec_tpu_torch.ops.spmm_dense.DenseMat`, a GEMM with f32
sums). :func:`norm_adj_from_scipy` picks between them by the JAX package's
own gates (``SELFREC_TPU_DENSE``, ``SELFREC_TPU_ELL``). Not ported yet: the
sharded layouts (ROADMAP.md §1.8).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from selfrec_tpu_torch.ops import spmm_dense
from selfrec_tpu_torch.ops.spmm_dense import (DenseAdj, DenseMat, dense_mat_spmm,
                                               dense_spmm)
from selfrec_tpu_torch.ops.spmm_ell import (EllAdj, ell_adj_from_edges, ell_spmm,
                                            ell_spmm_packed)


class NormAdj:
    """Normalized sparse adjacency in edge-list form (graph.py:29-54):
    ``out[d] = sum of w[e] * x[src[e]] over edges e with dst[e] == d``,
    ``n_nodes`` output rows. ``sorted_by_dst`` records that the edges come
    in destination order, as :func:`norm_adj_from_scipy` builds them."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                 n_nodes: int, sorted_by_dst: bool = False):
        self.src = src
        self.dst = dst
        self.w = w
        self.n_nodes = n_nodes
        self.sorted_by_dst = sorted_by_dst

    @property
    def edge_w(self) -> torch.Tensor:
        """The edge weights, under the name the other layouts give them."""
        return self.w

    def __repr__(self):
        return f"NormAdj(E={self.src.shape[0]}, n_nodes={self.n_nodes})"


def norm_adj_spmm(adj: NormAdj, x: torch.Tensor) -> torch.Tensor:
    """Gather the rows ``x[src]``, scale by ``w`` and sum into ``dst``
    (graph.py:85-89), differentiable in ``x`` and ``w``. On the CPU
    ``index_add`` sums each row's edges in edge order, as XLA's segment sum
    does there; on CUDA it adds with float atomics, whose order, and so the
    last bits of a sum, varies from run to run. The gather is
    ``index_select``, whose gradient is one ``index_add`` into ``x``'s
    rows; advanced indexing's gradient sorts the indices first, which made
    the backward the larger part of a LightGCN step on the card. A
    row-major ``x`` keeps the gather's reads of each row contiguous."""
    contrib = x.index_select(0, adj.src) * adj.w[:, None]
    out = torch.zeros((adj.n_nodes,) + tuple(x.shape[1:]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add(0, adj.dst, contrib)


def spmm(adj, x: torch.Tensor) -> torch.Tensor:
    """(normalized adjacency) @ (embeddings) over the unified node space."""
    if isinstance(adj, DenseAdj):
        return dense_spmm(adj, x)
    if isinstance(adj, EllAdj):
        return ell_spmm(adj, x)
    if isinstance(adj, NormAdj):
        return norm_adj_spmm(adj, x)
    if isinstance(adj, DenseMat):
        return dense_mat_spmm(adj, x)
    raise NotImplementedError(
        f"spmm over {type(adj).__name__}: the port propagates DenseAdj, EllAdj, "
        "NormAdj and DenseMat; the sharded layouts are queued in ROADMAP.md (§1.8)")


def spmm_packed(adj, w_edge_stack: torch.Tensor, x: torch.Tensor,
                n_passes: int) -> torch.Tensor:
    """P propagation passes sharing one layout, packed into one gather chain
    (x is (n, P*D); ``w_edge_stack`` (P, E) per-pass weights in original
    edge order): one K2 launch per hop for all P passes."""
    if isinstance(adj, EllAdj):
        return ell_spmm_packed(adj, w_edge_stack, x, n_passes)
    raise TypeError(f"packed SpMM needs a shared layout, got {type(adj)}")


def supports_packed(adj) -> bool:
    return isinstance(adj, EllAdj)


def lightgcn_propagate(adj, ego: torch.Tensor, n_layers: int,
                       include_layer0: bool = True,
                       return_layers: bool = False):
    """K-layer LightGCN propagation, mean over layer outputs.

    ``include_layer0=True`` matches LightGCN (reference LightGCN.py:68-78);
    SimGCL averages layers 1..K only (reference SimGCL.py:83-91)."""
    layers: List[torch.Tensor] = [ego] if include_layer0 else []
    e = ego
    for _ in range(n_layers):
        e = spmm(adj, e)
        layers.append(e)
    out = torch.mean(torch.stack(layers, dim=0), dim=0)
    if return_layers:
        all_layers = [ego] + layers[1:] if include_layer0 else [ego] + layers
        return out, all_layers
    return out


def _noised(e: torch.Tensor, u: torch.Tensor, eps: float) -> torch.Tensor:
    """``e + sign(e) * eps * rownorm(u)``, u a U[0,1) draw (SimGCL.py:85-88)."""
    u = u / (torch.linalg.norm(u, dim=-1, keepdim=True) + 1e-12)
    return e + torch.sign(e) * u * eps


def perturbed_propagate(adj, ego: torch.Tensor, n_layers: int, eps: float,
                        generator: Optional[torch.Generator] = None,
                        cl_layer: Optional[int] = None,
                        noise: Optional[Sequence[torch.Tensor]] = None):
    """SimGCL/XSimGCL noise-perturbed propagation (graph.py:140-172).

    After each hop adds ``sign(e) * eps * rownorm(U[0,1))``, then averages
    layers 1..K. With ``cl_layer`` also returns the layer-``cl_layer``
    embedding (XSimGCL.py:93-101; ``cl_layer=0`` is the unperturbed ego).

    Hop k's (n, D) draw comes from ``generator``, one ``torch.rand`` a hop
    in hop order (the JAX package splits its key into ``n_layers`` keys, one
    a hop), or from ``noise[k]`` when given, so tests can feed JAX's draws."""
    layers: List[torch.Tensor] = []
    e = ego
    cl_emb = ego
    for k in range(n_layers):
        e = spmm(adj, e)
        u = noise[k] if noise is not None else torch.rand(
            e.shape, generator=generator, device=e.device, dtype=e.dtype)
        e = _noised(e, u, eps)
        layers.append(e)
        if cl_layer is not None and k == cl_layer - 1:
            cl_emb = e
    out = torch.mean(torch.stack(layers, dim=0), dim=0)
    if cl_layer is not None:
        return out, cl_emb
    return out


def fused_simgcl_propagate(adj, ego: torch.Tensor, n_layers: int, eps: float,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[Sequence[Sequence[torch.Tensor]]] = None):
    """SimGCL's three propagation chains (1 clean + 2 noise-perturbed,
    SimGCL.py:27-47) fused into ONE width-3D propagation (graph.py:256-292).

    Propagation is linear, so spmm(adj, concat) == concat(spmm(adj, .)); the
    per-pass noise ``sign(e) * eps * rownorm(U[0,1))`` (SimGCL.py:85-88) is
    applied to the two perturbed slices after each hop. All three outputs
    average layers 1..K.

    The U[0,1) draws come from ``generator``, or from ``noise[k][j]`` (hop
    k, view j, each (n, D)) when given, so tests can feed the JAX package's
    draws. Returns (clean, view1, view2), each (n, D)."""
    d = ego.shape[1]
    x = torch.cat([ego, ego, ego], dim=1)
    acc = torch.zeros_like(x)
    for k in range(n_layers):
        x = spmm(adj, x)
        c, p1, p2 = x[:, :d], x[:, d: 2 * d], x[:, 2 * d:]
        parts = [c]
        for j, p in enumerate((p1, p2)):
            if noise is not None:
                u = noise[k][j]
            else:
                u = torch.rand(p.shape, generator=generator, device=p.device,
                               dtype=p.dtype)
            parts.append(_noised(p, u, eps))
        x = torch.cat(parts, dim=1)
        acc = acc + x
    out = acc / n_layers
    return out[:, :d], out[:, d: 2 * d], out[:, 2 * d:]


def bipartite_renorm_weights(edge_users: torch.Tensor, edge_items: torch.Tensor,
                             keep: torch.Tensor, n_users: int,
                             n_items: int) -> torch.Tensor:
    """(2E,) symmetric-normalized weights over kept edges, ordered
    [u→i edges ; i→u edges] (graph.py:175-195): the weights of a dropped
    view over the template of :func:`build_bipartite_ell_template`."""
    w_e = keep.to(torch.float32)
    du = torch.zeros(n_users, dtype=torch.float32, device=w_e.device)
    di = torch.zeros(n_items, dtype=torch.float32, device=w_e.device)
    du.index_add_(0, edge_users, w_e)
    di.index_add_(0, edge_items, w_e)
    inv_sqrt_du = torch.where(du > 0, torch.rsqrt(torch.clamp(du, min=1e-12)), 0.0)
    inv_sqrt_di = torch.where(di > 0, torch.rsqrt(torch.clamp(di, min=1e-12)), 0.0)
    w = w_e * inv_sqrt_du[edge_users] * inv_sqrt_di[edge_items]
    return torch.cat([w, w])


def build_bipartite_ell_template(edge_users, edge_items, n_users: int,
                                 n_items: int, k: int = 16,
                                 device="cuda") -> EllAdj:
    """Static EllAdj over the symmetric bipartite edge list (host, one-time,
    graph.py:198-210); reweight with :func:`bipartite_renorm_weights`. K is
    16 whatever ``SELFREC_TPU_ELL_K`` says, as in the JAX package."""
    eu = np.asarray(edge_users)
    ei = np.asarray(edge_items)
    src = np.concatenate([eu, ei + n_users])
    dst = np.concatenate([ei + n_users, eu])
    w = np.ones(2 * len(eu), dtype=np.float32)
    return ell_adj_from_edges(src, dst, w, n_rows=n_users + n_items, k=k,
                              device=device)


def union_ell_template(mats, k: int = 16, device="cuda"):
    """One ELL layout over the UNION sparsity pattern of several same-shape
    scipy matrices, and the (P, E) per-view weight stack in the template's
    edge order (graph.py:213-253): a view that lacks a union edge carries
    weight 0 in that slot, so :func:`spmm_packed` runs all P propagations
    as one K2 chain. SEPT's social and sharing views are both ``(·)⊙S +
    I`` patterns (reference SEPT.py:33-40), so their union is barely larger
    than either. K is 16 whatever ``SELFREC_TPU_ELL_K`` says, as in the JAX
    package. Returns (template: EllAdj with all-ones weights, w_stack)."""
    import scipy.sparse as sp

    n_rows, n_cols = mats[0].shape
    union = None
    for m in mats:
        if m.shape != (n_rows, n_cols):
            raise ValueError(f"union_ell_template: shapes {m.shape} and "
                             f"{(n_rows, n_cols)} differ")
        pat = m.tocoo()
        pat = sp.coo_matrix((np.ones(pat.nnz, np.float32), (pat.row, pat.col)),
                            shape=m.shape)
        union = pat if union is None else union + pat
    union = union.tocoo()
    rows, cols = union.row.astype(np.int32), union.col.astype(np.int32)
    w_stack = np.stack([np.asarray(m.tocsr()[rows, cols]).ravel().astype(np.float32)
                        for m in mats])
    template = ell_adj_from_edges(cols, rows, np.ones(len(rows), np.float32),
                                  n_rows=n_rows, n_cols=n_cols, k=k, device=device)
    return template, torch.as_tensor(w_stack, device=device)


def adj_dropout(adj, rate, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
    """Per-step sparse dropout of adjacency entries (graph.py:320-352;
    reference BUIR.py:118-127): keep each edge with probability 1 - rate and
    scale kept weights by 1 / (1 - rate), with no degree renormalization.
    ``rate`` may be a 0-d tensor.

    A DenseAdj takes :meth:`DenseAdj.dropout_view`; an EllAdj (over its
    edges in their original order, both directions alike) and a NormAdj are
    reweighted with ``where(keep, w / (1 - rate), 0)``. ``keep`` (E,) bool
    over the adjacency's edge order is drawn as ``rand(E) >= rate`` from
    ``generator`` when not given. Other layouts raise."""
    if isinstance(adj, DenseAdj):
        return adj.dropout_view(rate, keep=keep, generator=generator)
    if not isinstance(adj, (EllAdj, NormAdj)):
        raise NotImplementedError(
            f"adj_dropout over {type(adj).__name__}: the port drops edges of "
            "DenseAdj, EllAdj and NormAdj (no model drops a static DenseMat); the "
            "sharded layouts are queued in ROADMAP.md (§1.8)")
    if keep is None:
        keep = torch.rand(adj.edge_w.shape, generator=generator,
                          device=adj.edge_w.device) >= rate
    w = torch.where(keep, adj.edge_w / (1.0 - rate), torch.zeros_like(adj.edge_w))
    if isinstance(adj, EllAdj):
        return adj.reweight(w)
    return NormAdj(adj.src, adj.dst, w, adj.n_nodes, adj.sorted_by_dst)


def dense_general_available(m: int, n: int, device="cuda") -> bool:
    """Whether a static (m, n) matrix takes the dense :class:`DenseMat`
    under the gates :func:`norm_adj_from_scipy` applies with
    ``dense_general=True`` (graph.py:355-369): ``SELFREC_TPU_DENSE`` ``0``
    never, ``1`` whenever the block fits ``SELFREC_TPU_DENSE_BUDGET_GB`` in
    ``_generic_dtype()``, anything else (default ``auto``) only when it
    fits and ``device`` is CUDA."""
    mode = os.environ.get("SELFREC_TPU_DENSE", "auto")
    if mode == "0":
        return False
    return (spmm_dense.fits_dense(m, n, spmm_dense._generic_dtype())
            and (mode == "1" or torch.device(device).type == "cuda"))


def norm_adj_from_scipy(norm_adj, n_users: Optional[int] = None, k: int = 16,
                        device="cuda", dense_general: bool = False):
    """Device adjacency from the host scipy normalized matrix (one-time
    setup; graph.py:372-430).

    ``dense_general=True`` opts a static square or rectangular matrix of any
    values (MHCN's motif channels and rating blocks) into the dense
    :class:`DenseMat` when :func:`dense_general_available` allows it.

    With ``n_users`` given for a square unified Laplacian, the dense
    bipartite block is built when ``SELFREC_TPU_DENSE`` allows it: ``0``
    never, ``1`` whenever the (U, I) block fits
    ``SELFREC_TPU_DENSE_BUDGET_GB``, anything else (default ``auto``) only
    when it fits and ``device`` is CUDA, and in every case only when the
    matrix is symmetric-bipartite. Otherwise the row-split ELL layout, with
    K from ``SELFREC_TPU_ELL_K`` (default ``k``), or with
    ``SELFREC_TPU_ELL=0`` the edge-list :class:`NormAdj`, its edges sorted
    by destination (graph.py:430-438); rectangular matrices have rows as
    destinations."""
    device = torch.device(device)
    if (dense_general and n_users is None
            and dense_general_available(*norm_adj.shape, device=device)):
        return spmm_dense.dense_mat_from_scipy(norm_adj, device=device)
    coo = norm_adj.tocoo()
    dense_mode = os.environ.get("SELFREC_TPU_DENSE", "auto")
    if n_users is not None and dense_mode != "0":
        n_items = norm_adj.shape[0] - n_users
        if (norm_adj.shape[0] == norm_adj.shape[1]
                and spmm_dense.fits_dense(n_users, n_items)
                and (dense_mode == "1" or device.type == "cuda")):
            blocks = spmm_dense.bipartite_blocks(coo, n_users)
            if blocks is not None:
                eu, ei, w = blocks
                return spmm_dense.dense_adj_from_edges(eu, ei, w, n_users,
                                                       n_items, device=device)
    if os.environ.get("SELFREC_TPU_ELL", "1") == "0":
        order = np.argsort(coo.row, kind="stable")
        as_dev = lambda a, dt: torch.as_tensor(a[order].astype(dt), device=device)
        return NormAdj(as_dev(coo.col, np.int64), as_dev(coo.row, np.int64),
                       as_dev(coo.data, np.float32), norm_adj.shape[0],
                       sorted_by_dst=True)
    k = int(os.environ.get("SELFREC_TPU_ELL_K", k))
    return ell_adj_from_edges(
        coo.col.astype(np.int32), coo.row.astype(np.int32),
        coo.data.astype(np.float32), n_rows=norm_adj.shape[0],
        n_cols=norm_adj.shape[1], k=k, device=device)
