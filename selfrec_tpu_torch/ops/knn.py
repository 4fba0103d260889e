"""Top-k shrunk-cosine neighbour build for UserKNN and ItemKNN (counterpart
of ``selfrec_tpu/ops/knn.py``).

The binary incidence R (n_dst x n_src) is scattered once on the device as
int8, padded to whole blocks of rows. For each block the co-occurrence
counts ``R[block] @ R^T`` are summed exactly in int32 and cast to f32
(exact: counts are small integers), then the shrunk cosine
``C/(C+shrink) * C/(sqrt(d_i) sqrt(d_j) + 1e-8)`` in the JAX package's
expression order (:func:`shrunk_cosine`), self-exclusion, the top-k with ties by the lowest index
(``lax.top_k``'s order), and non-positive sims clamped to 0.

The JAX package computes R R^T as an XLA ``dot_general``, outside any
Pallas kernel, so this is no kernel port: on CUDA the product is a stock
int8 GEMM (``torch._int_mm``, whose contraction length must be a multiple
of 8; R's columns are padded with zeros, which change no count, to a
multiple of 64, since at a multiple of only 8 cuBLAS takes a kernel for
4-byte-aligned rows at half the speed), on the CPU a plain int32
product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from selfrec_tpu_torch.ops.graph import spmm
from selfrec_tpu_torch.ops.ranking import csr_pairs, topk_lowest_index
from selfrec_tpu_torch.ops.spmm_dense import fits_dense_elems

BLOCK = 1024


def dense_available(n_dst: int, n_src: int, block: int = BLOCK) -> bool:
    """Device-memory gate (knn.py:37-42): the int8 R plus the (block,
    n_dst) f32 transient of one block."""
    n_pad = -(-n_dst // block) * block
    return (fits_dense_elems(n_pad * n_src, dtype=torch.int8)
            and fits_dense_elems(block * n_pad, dtype=torch.float32))


EPS = float(np.float32(1e-8))  # the f32 value of the JAX package's 1e-8


def shrunk_cosine(common: torch.Tensor, sqrt_dst: torch.Tensor, sqrt_src: torch.Tensor,
                  shrinkage: float) -> torch.Tensor:
    """``common / (common + shrinkage) * (common / (sqrt_dst[:, None] *
    sqrt_src[None, :] + 1e-8))`` in f32 (knn.py:62-66). XLA's CPU backend
    contracts the denominator's product and sum into one fused multiply-add,
    rounded once; so the port computes it exactly in f64 (the product of
    two f32 values is exact there, and at these magnitudes the f64 sum never
    rounds onto an f32 rounding midpoint) and rounds once to f32, the same
    value on every device."""
    den = (sqrt_dst.double()[:, None] * sqrt_src.double()[None, :] + EPS).float()
    return common / (common + shrinkage) * (common / den)


def cooccurrence(rows: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``rows @ r.T`` for int8 0/1 ``rows`` (m, k) and ``r`` (n, k), summed
    exactly in int32: ``torch._int_mm`` on CUDA (k and n multiples of 8,
    m above 16), an int32 product on the CPU."""
    if rows.is_cuda:
        return torch._int_mm(rows, r.T)
    return rows.to(torch.int32) @ r.to(torch.int32).T


def topk_shrunk_cosine(edge_dst: np.ndarray, edge_src: np.ndarray, n_dst: int,
                       n_src: int, degrees: torch.Tensor, shrinkage: float, k: int,
                       block: int = BLOCK, device=None
                       ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """``(sims, ids)``, each (n_dst, k), of each dst entity's top-``k``
    shrunk-cosine neighbours (knn.py:45-102), or None when the dense
    incidence exceeds the budget (callers then take their blocked
    edge-list build). ``degrees`` (n_dst,) are the entities' interaction
    counts; the result sits on ``device`` (default ``degrees``')."""
    if not dense_available(n_dst, n_src, block):
        return None
    device = degrees.device if device is None else torch.device(device)
    n_blocks = -(-n_dst // block)
    n_pad = n_blocks * block
    src_pad = -(-n_src // 64) * 64
    r = torch.zeros((n_pad, src_pad), dtype=torch.int8, device=device)
    r[torch.as_tensor(np.asarray(edge_dst, np.int64), device=device),
      torch.as_tensor(np.asarray(edge_src, np.int64), device=device)] = 1
    sqrt_deg = torch.sqrt(torch.nn.functional.pad(
        degrees.to(device, torch.float32), (0, n_pad - n_dst)))
    sims, ids = [], []
    lane = torch.arange(block, device=device)
    for b in range(n_blocks):
        common = cooccurrence(r[b * block:(b + 1) * block], r).to(torch.float32)[:, :n_dst]
        blk = b * block + lane
        sim = shrunk_cosine(common, sqrt_deg[blk], sqrt_deg[:n_dst], shrinkage)
        sim[lane, blk.clamp(0, n_dst - 1)] = -torch.inf
        top_sim, top_ids = topk_lowest_index(sim, k)
        sims.append(torch.where(top_sim > 0, top_sim, torch.zeros_like(top_sim)))
        ids.append(top_ids)
    return torch.cat(sims)[:n_dst], torch.cat(ids)[:n_dst].to(torch.int32)


def dense_rows(offsets: np.ndarray, cols: np.ndarray, ids: np.ndarray, width: int,
               device) -> torch.Tensor:
    """(len(ids), width) f32 0/1 rows of a CSR (``offsets``, ``cols``) for
    the entities ``ids``, duplicates included (userknn.py:49-54), scattered
    on ``device``."""
    rows, c = csr_pairs(offsets, cols, ids)
    block = torch.zeros((len(ids), width), dtype=torch.float32, device=device)
    block[torch.as_tensor(rows.astype(np.int64), device=device),
          torch.as_tensor(c.astype(np.int64), device=device)] = 1.0
    return block


def blocked_topk_shrunk_cosine(adj, offsets: np.ndarray, cols: np.ndarray,
                               degrees: torch.Tensor, n_src: int, shrinkage: float,
                               k: int, block: int = 512
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The budget fallback of :func:`topk_shrunk_cosine`
    (userknn.py:79-117, itemknn.py:92-125): per block of ``block`` dst
    entities (the last padded with its last id), their dense incidence
    rows from the CSR (``offsets``, ``cols``), the counts
    ``spmm(adj, rows.T).T`` over the edge-list ``adj`` (dst <- src edges of
    unit weight; f32 sums of ones, exact in any order), then the same
    shrunk cosine, self-exclusion and top-k. Returns (sims, ids) on
    ``degrees``' device."""
    n_dst = degrees.shape[0]
    dev = degrees.device
    sqrt_deg = torch.sqrt(degrees.to(torch.float32))
    sims, ids = [], []
    for b0 in range(0, n_dst, block):
        valid = min(block, n_dst - b0)
        blk = np.arange(b0, b0 + block, dtype=np.int64).clip(max=n_dst - 1)
        rows = dense_rows(offsets, cols, blk, n_src, dev)
        common = spmm(adj, rows.T.contiguous()).T
        blk = torch.as_tensor(blk, device=dev)
        sim = shrunk_cosine(common, sqrt_deg[blk], sqrt_deg, shrinkage)
        sim[torch.arange(block, device=dev), blk] = -torch.inf
        top_sim, top_ids = topk_lowest_index(sim, k)
        sims.append(torch.where(top_sim > 0, top_sim, torch.zeros_like(top_sim))[:valid])
        ids.append(top_ids[:valid])
    return torch.cat(sims), torch.cat(ids).to(torch.int32)
