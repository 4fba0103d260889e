"""Host-side sparse graph normalisation (one-time preprocessing).

Semantics match the reference's ``Graph.normalize_graph_mat``
(reference/data/graph.py:9-24): symmetric D^-1/2 A D^-1/2 for square
matrices, row-normalised D^-1 A otherwise. This runs once at dataset build
time on the host (scipy); steady-state propagation uses the edge arrays
produced by :mod:`selfrec_tpu_torch.data.interaction` on device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def normalize_graph_mat(adj_mat: sp.spmatrix) -> sp.spmatrix:
    shape = adj_mat.get_shape()
    rowsum = np.asarray(adj_mat.sum(1)).flatten()
    if shape[0] == shape[1]:
        with np.errstate(divide="ignore"):
            d_inv = np.power(rowsum, -0.5)
        d_inv[np.isinf(d_inv)] = 0.0
        d_mat = sp.diags(d_inv)
        return d_mat.dot(adj_mat).dot(d_mat)
    with np.errstate(divide="ignore"):
        d_inv = np.power(rowsum, -1.0)
    d_inv[np.isinf(d_inv)] = 0.0
    return sp.diags(d_inv).dot(adj_mat)


def csr_to_edges(mat: sp.spmatrix, sort_by_row: bool = True):
    """Flatten a scipy sparse matrix into (row, col, val) int32/float32 arrays.

    Rows sorted ascending so on-device segment reductions can use
    ``indices_are_sorted=True``.
    """
    coo = mat.tocoo()
    row = coo.row.astype(np.int32)
    col = coo.col.astype(np.int32)
    val = coo.data.astype(np.float32)
    if sort_by_row:
        order = np.argsort(row, kind="stable")
        row, col, val = row[order], col[order], val[order]
    return row, col, val


class Graph:
    """Class-surface parity with the reference ``Graph`` base
    (reference/data/graph.py:5-27)."""

    @staticmethod
    def normalize_graph_mat(adj_mat):
        return normalize_graph_mat(adj_mat)
