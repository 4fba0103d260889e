"""Social motif and view matrices, built once before training (counterpart
of ``selfrec_tpu/data/motifs.py``).

MHCN's motif hypergraphs (reference MHCN.py:27-55) and SEPT's social and
sharing views (SEPT.py:33-40), two ways:

- the scipy route (:func:`mhcn_hypergraphs`, :func:`sept_views`), sparse
  algebra on the host, whose results the ELL layouts take;
- the device route (:func:`mhcn_hypergraphs_device`,
  :func:`sept_views_device`), the same products term for term as dense
  f32 (U, U) and (U, I) matrix products on ``device``, which the dense
  ``DenseMat`` arm takes. The JAX package runs them in XLA at
  ``Precision.HIGHEST`` so that integer motif counts stay exact in f32;
  here they are plain ``torch.matmul`` with TF32 off inside
  :func:`selfrec_tpu_torch.device.full_f32_matmul`, whatever the caller's
  setting.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from selfrec_tpu_torch.data.graph import normalize_graph_mat
from selfrec_tpu_torch.device import full_f32_matmul


def _row_normalize(h: sp.spmatrix) -> sp.csr_matrix:
    """H ⊙ (1 / rowsum) (reference MHCN.py:49-54; rows with no entries
    contribute no nonzeros, so the 1/0 never materializes)."""
    rs = np.asarray(h.sum(axis=1)).reshape(-1, 1)
    with np.errstate(divide="ignore"):
        inv = np.where(rs > 0, 1.0 / np.maximum(rs, 1e-32), 0.0)
    return h.multiply(inv).tocsr()


def mhcn_hypergraphs(social_mat: sp.spmatrix, interaction_mat: sp.spmatrix):
    """[H_s, H_j, H_p] row-normalized motif hypergraphs (MHCN.py:27-55)."""
    S = social_mat.tocsr()
    Y = interaction_mat.tocsr()
    B = S.multiply(S.T)
    U = (S - B).tocsr()
    C1 = (U.dot(U)).multiply(U.T)
    A1 = C1 + C1.T
    C2 = (B.dot(U)).multiply(U.T) + (U.dot(B)).multiply(U.T) + (U.dot(U)).multiply(B)
    A2 = C2 + C2.T
    C3 = (B.dot(B)).multiply(U) + (B.dot(U)).multiply(B) + (U.dot(B)).multiply(B)
    A3 = C3 + C3.T
    A4 = (B.dot(B)).multiply(B)
    C5 = (U.dot(U)).multiply(U) + (U.dot(U.T)).multiply(U) + (U.T.dot(U)).multiply(U)
    A5 = C5 + C5.T
    A6 = (U.dot(B)).multiply(U) + (B.dot(U.T)).multiply(U.T) + (U.T.dot(U)).multiply(B)
    A7 = (U.T.dot(B)).multiply(U.T) + (B.dot(U)).multiply(U) + (U.dot(U.T)).multiply(B)
    A8 = (Y.dot(Y.T)).multiply(B)
    A9 = (Y.dot(Y.T)).multiply(U)
    A9 = A9 + A9.T
    A10 = Y.dot(Y.T) - A8 - A9
    H_s = _row_normalize(sum([A1, A2, A3, A4, A5, A6, A7]))
    H_j = _row_normalize(sum([A8, A9]))
    H_p = A10.multiply(A10 > 3)
    H_p = _row_normalize(H_p)
    return [H_s, H_j, H_p]


def sept_views(bi_social_mat: sp.spmatrix, interaction_mat: sp.spmatrix, n_users: int):
    """(social_view, sharing_view): (S·S)⊙S + I and (Y·Yᵀ)⊙S + I, each
    D^-1/2 A D^-1/2 normalized (reference SEPT.py:33-40)."""
    S = bi_social_mat.tocsr()
    Y = interaction_mat.tocsr()
    social = (S.dot(S)).multiply(S) + sp.eye(n_users, dtype=np.float32)
    sharing = (Y.dot(Y.T)).multiply(S) + sp.eye(n_users, dtype=np.float32)
    return normalize_graph_mat(social), normalize_graph_mat(sharing)


# -- the device route ---------------------------------------------------------


def _dense_from_scipy(mat, device) -> torch.Tensor:
    """(M, N) f32 block built on ``device`` by one scatter-add of the COO
    entries: only the edge arrays cross to the device."""
    coo = mat.tocoo()
    out = torch.zeros(mat.shape, dtype=torch.float32, device=device)
    idx = (torch.as_tensor(coo.row.astype(np.int64), device=device),
           torch.as_tensor(coo.col.astype(np.int64), device=device))
    return out.index_put_(idx, torch.as_tensor(coo.data.astype(np.float32), device=device),
                          accumulate=True)


def _row_normalize_dense(h: torch.Tensor) -> torch.Tensor:
    rs = torch.sum(h, dim=1, keepdim=True)
    return h * torch.where(rs > 0, 1.0 / torch.clamp(rs, min=1e-32), 0.0)


def mhcn_hypergraphs_device(social_mat, interaction_mat, device="cuda"):
    """[H_s, H_j, H_p] as dense (U, U) f32 tensors on ``device``: the math
    of :func:`mhcn_hypergraphs` as dense products (motifs.py:102-146)."""
    with torch.no_grad(), full_f32_matmul():
        S = _dense_from_scipy(social_mat, device)
        Y = _dense_from_scipy(interaction_mat, device)
        B = S * S.T
        U = S - B
        del S
        Ut = U.T
        # each distinct product once (XLA shares them the same way)
        UU, BU, UB, BB = U @ U, B @ U, U @ B, B @ B
        UUt, UtU, BUt, UtB = U @ Ut, Ut @ U, B @ Ut, Ut @ B
        C1 = UU * Ut
        Hs = C1 + C1.T
        C2 = BU * Ut + UB * Ut + UU * B
        Hs = Hs + C2 + C2.T
        C3 = BB * U + BU * B + UB * B
        Hs = Hs + C3 + C3.T
        Hs = Hs + BB * B  # A4
        C5 = UU * U + UUt * U + UtU * U
        Hs = Hs + C5 + C5.T
        Hs = Hs + UB * U + BUt * Ut + UtU * B  # A6
        Hs = Hs + UtB * Ut + BU * U + UUt * B  # A7
        del UU, BU, UB, BB, UUt, UtU, BUt, UtB
        del C1, C2, C3, C5
        Hs = _row_normalize_dense(Hs)
        YYt = Y @ Y.T
        del Y
        A8 = YYt * B
        A9 = YYt * U
        A9 = A9 + A9.T
        A10 = YYt - A8 - A9
        del YYt
        Hj = _row_normalize_dense(A8 + A9)
        del A8, A9
        Hp = _row_normalize_dense(A10 * (A10 > 3))
    return [Hs, Hj, Hp]


def sept_views_device(bi_social_mat, interaction_mat, n_users: int, device="cuda"):
    """(social_view, sharing_view) as dense (U, U) f32 tensors on
    ``device``: the math of :func:`sept_views` with its symmetric
    D^-1/2 A D^-1/2 normalization (motifs.py:149-175)."""
    with torch.no_grad(), full_f32_matmul():
        S = _dense_from_scipy(bi_social_mat, device)
        Y = _dense_from_scipy(interaction_mat, device)
        eye = torch.eye(n_users, dtype=torch.float32, device=device)
        social = (S @ S) * S + eye
        sharing = (Y @ Y.T) * S + eye

        def sym_norm(a):
            rs = torch.sum(a, dim=1)
            d = torch.where(rs > 0, torch.rsqrt(torch.clamp(rs, min=1e-32)), 0.0)
            return a * d[:, None] * d[None, :]

        return sym_norm(social), sym_norm(sharing)
