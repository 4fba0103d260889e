"""Dense-bipartite propagation of the port (selfrec_tpu_torch.ops.spmm_dense
and ops.graph) against the JAX package on the same numpy inputs.

Modes and tolerances:
- float32 factored: both run true f32 matmuls whose sums differ only in
  order, so rtol 1e-5.
- int8 factored: both quantize the same f32 operand identically and sum
  exactly in int32; the rescale is the same f32 products. Values and
  grads agree to rtol/atol 1e-6. At D = 32 JAX runs its Pallas kernel in
  interpret mode; at D = 192 (above its D <= 128 gate) it runs XLA's
  two int8 dots.
- generic (arbitrary weights, f32 block): rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from selfrec_tpu.ops import dense_dual as jax_dual
from selfrec_tpu.ops import graph as jax_graph
from selfrec_tpu.ops import spmm_dense as jax_dense
from selfrec_tpu_torch.ops import dense_dual
from selfrec_tpu_torch.ops import graph as t_graph
from selfrec_tpu_torch.ops import spmm_dense as t_dense
from selfrec_tpu_torch.ops.spmm_ell import EllAdj

NU, NI = 120, 160


def _edges(seed=3):
    rng = np.random.default_rng(seed)
    eu = np.repeat(np.arange(NU, dtype=np.int32), 4)
    ei = rng.integers(0, NI, len(eu)).astype(np.int32)
    eu, ei = np.unique(np.stack([eu, ei]), axis=1)
    du = np.bincount(eu, minlength=NU).astype(np.float64)
    di = np.bincount(ei, minlength=NI).astype(np.float64)
    w = (1.0 / np.sqrt(np.maximum(du[eu] * di[ei], 1.0))).astype(np.float32)
    return eu.astype(np.int32), ei.astype(np.int32), w


def _values_and_grads_jax(adj, x, wout):
    def f(x):
        return jnp.sum(jax_dense.dense_spmm(adj, x) * wout)

    out = jax_dense.dense_spmm(adj, jnp.asarray(x))
    g = jax.grad(f)(jnp.asarray(x))
    return np.asarray(out), np.asarray(g)


def _values_and_grads_torch(adj, x, wout):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t_dense.dense_spmm(adj, xt)
    torch.sum(out * torch.from_numpy(wout)).backward()
    return out.detach().numpy(), xt.grad.numpy()


def _both_adjs(monkeypatch, dtype_name, edges, dtype=None):
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", dtype_name)
    eu, ei, w = edges
    jadj = jax_dense.dense_adj_from_edges(
        eu, ei, w, NU, NI, dtype=None if dtype is None else jnp.dtype(dtype))
    tadj = t_dense.dense_adj_from_edges(
        eu, ei, w, NU, NI, dtype=None if dtype is None else getattr(torch, dtype),
        device="cpu")
    return jadj, tadj


def test_factored_structure_matches_jax(monkeypatch):
    jadj, tadj = _both_adjs(monkeypatch, "int8", _edges())
    assert jadj.factored and tadj.factored and tadj.mm_dtype == torch.int8
    np.testing.assert_array_equal(tadj.a_ui.numpy(), np.asarray(jadj.a_ui))
    np.testing.assert_array_equal(tadj.row_scale.numpy(), np.asarray(jadj.row_scale))
    np.testing.assert_array_equal(tadj.col_scale.numpy(), np.asarray(jadj.col_scale))
    assert float(tadj.gain) == float(jadj.gain)


@pytest.mark.parametrize("case", ["non_factorable", "duplicates", "constant"])
def test_try_factor_matches_jax(case):
    eu, ei, w = _edges()
    if case == "non_factorable":
        w = w * np.linspace(0.5, 1.5, len(w)).astype(np.float32)
    elif case == "duplicates":
        eu, ei, w = (np.concatenate([eu, eu[:3]]), np.concatenate([ei, ei[:3]]),
                     np.concatenate([w, w[:3]]))
    else:
        w = np.full_like(w, 0.25)
    ref = jax_dense._try_factor(eu, ei, w, NU, NI)
    got = t_dense._try_factor(eu, ei, w, NU, NI)
    assert (ref is None) == (got is None)
    if ref is not None:
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_quant_per_channel_matches_jax_including_ties_and_zero_columns():
    rng = np.random.default_rng(0)
    y = rng.normal(size=(200, 12)).astype(np.float32)
    y[:, 3] = 0.0                      # all-zero column: scale 1
    y[:, 5] = np.arange(200) % 5 - 2   # amax 2: y/scale lands on .5 ties
    y[0, 5] = 2.0
    y[:, 7] = 127.0 * (np.arange(200) % 3 - 1) / 2.0
    jq, js = jax_dense._quant_per_channel(jnp.asarray(y))
    tq, ts = t_dense._quant_per_channel(torch.from_numpy(y))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0, 3]) == 1.0


def test_float32_factored_values_and_grads(monkeypatch):
    jadj, tadj = _both_adjs(monkeypatch, "float32", _edges())
    rng = np.random.default_rng(1)
    x = rng.normal(size=(NU + NI, 64)).astype(np.float32)
    wout = rng.normal(size=x.shape).astype(np.float32)
    jo, jg = _values_and_grads_jax(jadj, x, wout)
    to, tg = _values_and_grads_torch(tadj, x, wout)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [32, 192])
def test_int8_values_and_grads(monkeypatch, d):
    jadj, tadj = _both_adjs(monkeypatch, "int8", _edges())
    # JAX's Pallas kernel in interpret mode where its gate allows (D <= 128)
    monkeypatch.setenv("SELFREC_TPU_DUAL", "1")
    monkeypatch.setenv("SELFREC_TPU_DUAL_INTERPRET", "1")
    assert jax_dual.dual_supported(d, jnp.int8) == (d <= 128)
    rng = np.random.default_rng(d)
    x = rng.normal(size=(NU + NI, d)).astype(np.float32)
    wout = rng.normal(size=x.shape).astype(np.float32)
    jo, jg = _values_and_grads_jax(jadj, x, wout)
    to, tg = _values_and_grads_torch(tadj, x, wout)
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)


def test_int8_backward_is_the_quantized_apply_not_the_transpose(monkeypatch):
    """Straight-through: the gradient is the same quantized propagation run
    on the cotangent (spmm_dense.py:491-503)."""
    _, tadj = _both_adjs(monkeypatch, "int8", _edges())
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(NU + NI, 64)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(NU + NI, 64)).astype(np.float32))
    xr = x.clone().requires_grad_(True)
    t_dense.dense_spmm(tadj, xr).backward(g)
    assert torch.equal(xr.grad, t_dense._dense_spmm_int8_apply(tadj, g))


def test_generic_mode_values_and_grads(monkeypatch):
    eu, ei, _ = _edges()
    w = np.random.default_rng(7).uniform(0.1, 2.0, len(eu)).astype(np.float32)
    jadj, tadj = _both_adjs(monkeypatch, "float32", (eu, ei, w), dtype="float32")
    assert not jadj.factored and not tadj.factored
    rng = np.random.default_rng(2)
    x = rng.normal(size=(NU + NI, 48)).astype(np.float32)
    wout = rng.normal(size=x.shape).astype(np.float32)
    jo, jg = _values_and_grads_jax(jadj, x, wout)
    to, tg = _values_and_grads_torch(tadj, x, wout)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)


def _laplacian():
    eu, ei, w = _edges()
    n = NU + NI
    rows = np.concatenate([eu, ei + NU])
    cols = np.concatenate([ei + NU, eu])
    return sp.coo_matrix((np.concatenate([w, w]), (rows, cols)), shape=(n, n)).tocsr()


def test_norm_adj_from_scipy_and_lightgcn_match_jax(monkeypatch):
    monkeypatch.setenv("SELFREC_TPU_DENSE", "1")
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "float32")
    mat = _laplacian()
    jadj = jax_graph.norm_adj_from_scipy(mat, n_users=NU)
    tadj = t_graph.norm_adj_from_scipy(mat, NU, device="cpu")
    assert isinstance(jadj, jax_dense.DenseAdj) and tadj.factored
    x = np.random.default_rng(4).normal(size=(NU + NI, 16)).astype(np.float32)
    for layer0 in (True, False):
        jo = jax_graph.lightgcn_propagate(jadj, jnp.asarray(x), 3, include_layer0=layer0)
        to = t_graph.lightgcn_propagate(tadj, torch.from_numpy(x), 3,
                                        include_layer0=layer0)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)


def test_norm_adj_from_scipy_refuses_instead_of_switching_layout(monkeypatch):
    """Where the dense block cannot serve, both packages take the ELL
    layout, or with ``SELFREC_TPU_ELL=0`` the edge-list NormAdj (the same
    arrays as JAX's, tests/test_torch_normadj.py); ``spmm`` over an object
    that is no adjacency layout raises instead of guessing one."""
    monkeypatch.setenv("SELFREC_TPU_DENSE", "1")
    mat = _laplacian().tolil()
    mat[0, 1] = 0.5  # a user-user entry: not bipartite
    nonbip = mat.tocsr()
    assert isinstance(t_graph.norm_adj_from_scipy(nonbip, NU, device="cpu"), EllAdj)
    assert type(jax_graph.norm_adj_from_scipy(nonbip, n_users=NU)).__name__ == "EllAdj"
    monkeypatch.setenv("SELFREC_TPU_DENSE_BUDGET_GB", "0.000001")
    assert isinstance(t_graph.norm_adj_from_scipy(_laplacian(), NU, device="cpu"), EllAdj)
    monkeypatch.setenv("SELFREC_TPU_ELL", "0")
    edge_list = t_graph.norm_adj_from_scipy(_laplacian(), NU, device="cpu")
    assert isinstance(edge_list, t_graph.NormAdj)
    assert type(jax_graph.norm_adj_from_scipy(_laplacian(), n_users=NU)).__name__ == "NormAdj"
    x = np.random.default_rng(5).normal(size=(NU + NI, 16)).astype(np.float32)
    np.testing.assert_allclose(
        t_graph.spmm(edge_list, torch.from_numpy(x)).numpy(),
        np.asarray(jax_graph.spmm(jax_graph.norm_adj_from_scipy(_laplacian(), n_users=NU),
                                  jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    with pytest.raises(TypeError, match="not an adjacency layout"):
        t_graph.spmm(object(), torch.zeros(1, 1))


def test_bipartite_blocks_matches_jax():
    coo = _laplacian().tocoo()
    ref = jax_dense.bipartite_blocks(coo, NU)
    got = t_dense.bipartite_blocks(coo, NU)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    asym = coo.copy()
    asym.data = asym.data.copy()
    asym.data[0] *= 2.0
    assert t_dense.bipartite_blocks(asym, NU) is None
    assert jax_dense.bipartite_blocks(asym, NU) is None


def test_int8_propagation_calls_the_kernel_wrapper(monkeypatch):
    """Every int8 propagation goes through dual_matmul, at any D."""
    _, tadj = _both_adjs(monkeypatch, "int8", _edges())
    calls = []
    real = dense_dual.dual_matmul

    def spy(b, xu, xi, bt=None):
        # the block's kept transpose rides along for the item direction
        assert bt is not None and torch.equal(bt, b.T)
        calls.append(xu.shape[1])
        return real(b, xu, xi, bt)

    monkeypatch.setattr(dense_dual, "dual_matmul", spy)
    x = torch.randn(NU + NI, 192, requires_grad=True)
    t_dense.dense_spmm(tadj, x).sum().backward()
    t_dense.dense_spmm(tadj, x[:, :64].detach())
    assert calls == [192, 192, 64]


# -- the bf16 and f32 modes sum in f32 (K1's float kernel on the card) ------
# Both packages round the scaled operand to the matmul dtype the same way and
# sum exact products in f32, in another order: values and grads within rtol
# 1e-5 / atol 1e-6 in every dense mode. The backward multiplies the f32
# cotangent and rounds only the product to the operand dtype, as JAX's VJP
# of dot_general(..., preferred_element_type=f32) does.


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_factored_float_modes_match_jax_forward_and_vjp(monkeypatch, dtype):
    jadj, tadj = _both_adjs(monkeypatch, dtype, _edges())
    assert tadj.factored and tadj.mm_dtype == getattr(torch, dtype)
    assert not hasattr(tadj, "a_mm") and torch.equal(tadj.a_iu, tadj.a_ui.T)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(NU + NI, 64)).astype(np.float32)
    wout = rng.normal(size=x.shape).astype(np.float32)
    jo, jg = _values_and_grads_jax(jadj, x, wout)
    to, tg = _values_and_grads_torch(tadj, x, wout)
    assert to.dtype == tg.dtype == np.float32
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_generic_bf16_block_sums_in_f32_like_jax(monkeypatch, dtype):
    """A value block (arbitrary weights) in bf16 or f32: the operands
    rounded to its dtype, products exact in f32 and summed in f32."""
    eu, ei, _ = _edges()
    w = np.random.default_rng(7).uniform(0.1, 2.0, len(eu)).astype(np.float32)
    jadj, tadj = _both_adjs(monkeypatch, dtype, (eu, ei, w), dtype=dtype)
    assert not tadj.factored and tadj.a_ui.dtype == getattr(torch, dtype)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(NU + NI, 24)).astype(np.float32)
    wout = rng.normal(size=x.shape).astype(np.float32)
    jo, jg = _values_and_grads_jax(jadj, x, wout)
    to, tg = _values_and_grads_torch(tadj, x, wout)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)


def test_float_modes_run_k1_products_and_never_torch_matmul(monkeypatch):
    """The factored bf16 mode goes through K1's products forward (bf16
    operands) and backward (f32 cotangents), never through torch.matmul."""
    _, tadj = _both_adjs(monkeypatch, "bfloat16", _edges())
    calls = []
    real = dense_dual.float_products

    def spy(b, bt, xu, xi):
        assert b is tadj.a_ui and bt is tadj.a_iu
        calls.append((xu.dtype, xi.dtype))
        return real(b, bt, xu, xi)

    def no_matmul(*a, **k):
        raise AssertionError("torch.matmul on the dense float path")

    monkeypatch.setattr(dense_dual, "float_products", spy)
    monkeypatch.setattr(torch, "matmul", no_matmul)
    x = torch.randn(NU + NI, 32, requires_grad=True)
    out = t_dense.dense_spmm(tadj, x)
    assert out.dtype == torch.float32
    out.square().sum().backward()
    assert calls == [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)]
    assert x.grad.dtype == torch.float32
