"""The edge-list ``NormAdj`` of the port (ops/graph.py) against the JAX
package's (graph.py:29-54, 85-89, 350-352, 430-438): the layout that
``SELFREC_TPU_ELL=0`` asks for and that KNN propagates over.

Both sum each destination's edges in edge order on the CPU (index_add and
XLA's segment sum), but XLA's CPU backend may contract a product into its
sum as a fused multiply-add, so products and grads are held at rtol 1e-6 /
atol 1e-7, f32 rounding of the same sums; the arrays that
``norm_adj_from_scipy`` builds, and the dropped weights, are compared
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from selfrec_tpu.ops import graph as jax_graph
from selfrec_tpu_torch.ops import graph as t_graph
from selfrec_tpu_torch.ops.graph import NormAdj

N_ROWS, N_COLS, NNZ, D = 70, 50, 600, 8


def _matrix(seed=0, square=False):
    rng = np.random.default_rng(seed)
    n_cols = N_ROWS if square else N_COLS
    m = sp.coo_matrix((rng.random(NNZ).astype(np.float32),
                       (rng.integers(0, N_ROWS, NNZ), rng.integers(0, n_cols, NNZ))),
                      shape=(N_ROWS, n_cols))
    return m.tocsr()  # duplicates summed, as the Laplacian's are


def _both(mat, monkeypatch):
    monkeypatch.setenv("SELFREC_TPU_ELL", "0")
    monkeypatch.setenv("SELFREC_TPU_DENSE", "0")
    return (jax_graph.norm_adj_from_scipy(mat),
            t_graph.norm_adj_from_scipy(mat, device="cpu"))


@pytest.mark.parametrize("square", [False, True])
def test_norm_adj_from_scipy_builds_jax_arrays(monkeypatch, square):
    jadj, tadj = _both(_matrix(1, square), monkeypatch)
    assert isinstance(tadj, NormAdj) and type(jadj).__name__ == "NormAdj"
    assert tadj.n_nodes == jadj.n_nodes == N_ROWS
    assert tadj.sorted_by_dst and jadj.sorted_by_dst
    for name in ("src", "dst", "w"):
        np.testing.assert_array_equal(getattr(tadj, name).numpy(),
                                      np.asarray(getattr(jadj, name)))
    assert not t_graph.supports_packed(tadj)


@pytest.mark.parametrize("sorted_by_dst", [True, False])
def test_spmm_and_its_grad_match_jax(monkeypatch, sorted_by_dst):
    jadj, tadj = _both(_matrix(2), monkeypatch)
    if not sorted_by_dst:  # the KNN edge lists come in any order
        perm = np.random.default_rng(3).permutation(tadj.src.shape[0])
        jadj = jax_graph.NormAdj(jadj.src[perm], jadj.dst[perm], jadj.w[perm], N_ROWS)
        tadj = NormAdj(tadj.src[perm], tadj.dst[perm], tadj.w[perm], N_ROWS)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(N_COLS, D)).astype(np.float32)
    g = rng.normal(size=(N_ROWS, D)).astype(np.float32)
    jy, jvjp = jax.vjp(lambda x, w: jax_graph.spmm(
        jax_graph.NormAdj(jadj.src, jadj.dst, w, N_ROWS), x), jnp.asarray(x), jadj.w)
    jgx, jgw = jvjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = tadj.w.clone().requires_grad_(True)
    ty = t_graph.spmm(NormAdj(tadj.src, tadj.dst, tw, N_ROWS), tx)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-6, atol=1e-7)


def test_adj_dropout_with_a_fed_keep_matches_jax(monkeypatch):
    """JAX draws keep = uniform(key, E) >= rate (graph.py:350-352); fed
    that keep, the port's dropped weights are JAX's exactly, and so is the
    propagation over them (to f32 rounding)."""
    jadj, tadj = _both(_matrix(5), monkeypatch)
    key, rate = jax.random.PRNGKey(6), 0.3
    jdrop = jax_graph.adj_dropout(jadj, key, rate)
    keep = torch.from_numpy(np.array(jax.random.uniform(key, jadj.w.shape) >= rate))
    tdrop = t_graph.adj_dropout(tadj, rate, keep=keep)
    assert isinstance(tdrop, NormAdj) and tdrop.sorted_by_dst
    np.testing.assert_array_equal(tdrop.w.numpy(), np.asarray(jdrop.w))
    assert 0 < int((tdrop.w == 0).sum()) < tdrop.w.shape[0]
    x = np.random.default_rng(7).normal(size=(N_COLS, D)).astype(np.float32)
    np.testing.assert_allclose(t_graph.spmm(tdrop, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_graph.spmm(jdrop, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    # drawn from a generator: the same kept share, the rescale 1 / (1 - rate)
    drawn = t_graph.adj_dropout(tadj, rate, generator=torch.Generator().manual_seed(0))
    kept = drawn.w != 0
    torch.testing.assert_close(drawn.w[kept], tadj.w[kept] / (1 - rate))
