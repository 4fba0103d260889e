"""Graph propagation ops (counterpart of ``selfrec_tpu/ops/graph.py``).

This slice ports the dense-bipartite layout only: :func:`spmm` dispatches
``DenseAdj`` and raises for any other layout, and
:func:`norm_adj_from_scipy` builds the dense block or raises. The ELL
layout (and with it kernel K2) is ROADMAP.md item 10.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from selfrec_tpu_torch.ops import spmm_dense
from selfrec_tpu_torch.ops.spmm_dense import DenseAdj, dense_spmm


def spmm(adj, x: torch.Tensor) -> torch.Tensor:
    """(normalized adjacency) @ (embeddings) over the unified node space."""
    if isinstance(adj, DenseAdj):
        return dense_spmm(adj, x)
    raise NotImplementedError(
        f"spmm over {type(adj).__name__}: only the dense-bipartite layout is "
        "ported; the ELL layout is ROADMAP.md item 10")


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
            u = u / (torch.linalg.norm(u, dim=-1, keepdim=True) + 1e-12)
            parts.append(p + torch.sign(p) * u * eps)
        x = torch.cat(parts, dim=1)
        acc = acc + x
    out = acc / n_layers
    return out[:, :d], out[:, d: 2 * d], out[:, 2 * d:]


def norm_adj_from_scipy(norm_adj, n_users: int, device="cuda") -> DenseAdj:
    """Dense-bipartite device adjacency from the host scipy unified
    Laplacian (the dense branch of graph.py:404-415).

    Raises when the (U, I) block does not fit the budget or the matrix is
    not symmetric-bipartite: those graphs need the ELL layout, which is not
    ported (ROADMAP.md item 10). No other layout is picked silently."""
    n_items = norm_adj.shape[0] - n_users
    if norm_adj.shape[0] != norm_adj.shape[1]:
        raise NotImplementedError(
            "rectangular adjacency: needs the ELL layout, ROADMAP.md item 10")
    if not spmm_dense.fits_dense(n_users, n_items):
        raise NotImplementedError(
            f"the ({n_users}, {n_items}) dense block exceeds "
            "SELFREC_TPU_DENSE_BUDGET_GB; graphs that do not fit need the ELL "
            "layout, ROADMAP.md item 10")
    blocks = spmm_dense.bipartite_blocks(norm_adj.tocoo(), n_users)
    if blocks is None:
        raise NotImplementedError(
            "adjacency is not symmetric-bipartite: needs the ELL layout, "
            "ROADMAP.md item 10")
    eu, ei, w = blocks
    return spmm_dense.dense_adj_from_edges(eu, ei, w, n_users, n_items,
                                           device=device)
