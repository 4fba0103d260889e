"""k-means on the device, NCL's E-step (counterpart of
``selfrec_tpu/ops/kmeans.py``).

Lloyd's algorithm with a fixed 25 iterations, as faiss's default that the
reference calls (reference NCL.py:35-44): squared distances
``|x|^2 - 2 x.c + |c|^2`` through one plain matmul (the JAX package computes
them outside any Pallas kernel too), argmin assignment (the first minimum),
sums and counts by ``index_add_``, and an empty cluster keeps its centroid.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def kmeans(x: torch.Tensor, k: int, n_iters: int = 25,
           generator: Optional[torch.Generator] = None,
           init_idx: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (centroids (k, D), assignments (N,) int32).

    The k initial centroids are rows ``init_idx`` of x, or rows sampled
    from ``generator`` without replacement (with replacement when N < k),
    as ``jax.random.choice(key, n, (k,), replace=n < k)`` samples them."""
    n = x.shape[0]
    if init_idx is None:
        if n < k:
            init_idx = torch.randint(0, n, (k,), generator=generator, device=x.device)
        else:
            init_idx = torch.randperm(n, generator=generator, device=x.device)[:k]
    cents = x[init_idx.long()]
    x_sq = torch.sum(x * x, dim=1)
    ones = torch.ones((n,), dtype=x.dtype, device=x.device)

    def assign(c):
        d = x_sq[:, None] - 2.0 * (x @ c.T) + torch.sum(c * c, dim=1)[None]
        return torch.argmin(d, dim=1)

    for _ in range(n_iters):
        a = assign(cents)
        sums = torch.zeros_like(cents).index_add_(0, a, x)
        counts = torch.zeros((k,), dtype=x.dtype, device=x.device).index_add_(0, a, ones)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        cents = torch.where((counts > 0)[:, None], new, cents)
    return cents, assign(cents).to(torch.int32)
