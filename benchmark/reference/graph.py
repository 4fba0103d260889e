"""Plain float32 pieces of the graph models: the normalized adjacency worked
out from the edge arrays, LightGCN-style propagation, the rated-item mask
and the masked top-N. No kernel, no layout: a sparse matrix product.

SELFRec's adjacency (data/ui_graph.py) is the symmetric bipartite graph
of the training interactions, normalized as D^-1/2 A D^-1/2."""

from __future__ import annotations

import numpy as np
import torch


def norm_adj(train_u, train_i, n_users: int, n_items: int, device) -> torch.Tensor:
    """The (U+I, U+I) normalized adjacency as a float32 sparse CSR tensor."""
    u = torch.as_tensor(np.asarray(train_u), dtype=torch.int64, device=device)
    i = torch.as_tensor(np.asarray(train_i), dtype=torch.int64, device=device) + n_users
    n = n_users + n_items
    deg = torch.bincount(torch.cat([u, i]), minlength=n).to(torch.float32)
    inv = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
    rows, cols = torch.cat([u, i]), torch.cat([i, u])
    vals = inv[rows] * inv[cols]
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n), check_invariants=False)
    return coo.coalesce().to_sparse_csr()


class _SymmetricProduct(torch.autograd.Function):
    """``A @ x`` for a symmetric sparse A; its gradient is ``A @ g``."""

    @staticmethod
    def forward(ctx, adj, x):
        ctx.adj = adj
        return adj @ x

    @staticmethod
    def backward(ctx, g):
        return None, ctx.adj @ g.contiguous()


def spmm(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _SymmetricProduct.apply(adj, x)


def propagate_mean(adj, ego: torch.Tensor, n_layers: int) -> torch.Tensor:
    """The mean of layers 1..K of ``x <- A x`` (SimGCL's encoder,
    SELFRec model/graph/SimGCL.py: layer 0 left out)."""
    e, acc = ego, torch.zeros_like(ego)
    for _ in range(n_layers):
        e = spmm(adj, e)
        acc = acc + e
    return acc / n_layers


def rated_keys(train_u, train_i, n_items: int, device) -> torch.Tensor:
    """Sorted ``user * n_items + item`` keys of the training pairs: the
    rated set, for membership tests by binary search."""
    keys = (torch.as_tensor(np.asarray(train_u), dtype=torch.int64, device=device) * n_items
            + torch.as_tensor(np.asarray(train_i), dtype=torch.int64, device=device))
    return torch.sort(keys).values


def is_rated(keys: torch.Tensor, users: torch.Tensor, items: torch.Tensor, n_items: int):
    q = users.to(torch.int64) * n_items + items.to(torch.int64)
    pos = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    return keys[pos] == q

