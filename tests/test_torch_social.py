"""The social slice's data layer and propagation ops of the port against the
JAX package, on the same inputs:

- ``Relation`` and the scipy motif route: equal CSR matrices;
- the device motif route (torch f32 products, TF32 off in its own scope)
  against JAX's ``mhcn_hypergraphs_device`` / ``sept_views_device`` to rtol
  1e-6 (tests/test_social.py:239 holds JAX to itself there), and the MHCN
  hypergraphs equal to the scipy route exactly (integer motif counts);
- ``dense_mat_spmm`` forward and gradient against ``jax.vjp`` of JAX's:
  f32 sums to rtol 1e-5; in bf16 the gradient is bf16-representable and
  within one bf16 ulp of JAX's, element by element;
- ``dense_mat_from_scipy`` rounds each value before the add, as JAX's does
  (equal blocks);
- ``union_ell_template``: the JAX package's layout and weight stack, and
  a packed encode equal to two separate encodes (rtol/atol 1e-5, as
  tests/test_social.py:106);
- the ``dense_general`` gate and the session's ``social.data``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from selfrec_tpu.data import motifs as jax_motifs
from selfrec_tpu.data.interaction import Interaction as JaxInteraction
from selfrec_tpu.data.social import Relation as JaxRelation
from selfrec_tpu.ops import graph as jax_graph
from selfrec_tpu.ops import spmm_dense as jax_dense
from selfrec_tpu_torch.data import motifs
from selfrec_tpu_torch.data.interaction import Interaction
from selfrec_tpu_torch.data.social import Relation
from selfrec_tpu_torch.device import full_f32_matmul
from selfrec_tpu_torch.ops import graph as t_graph
from selfrec_tpu_torch.ops import spmm_dense
from selfrec_tpu_torch.ops.spmm_dense import DenseMat

from _social_data import social_relations


@pytest.fixture(scope="module")
def social(tiny_graph_dataset):
    train, test = tiny_graph_dataset
    data = Interaction(None, train, test)
    relations = social_relations()
    # a relation whose endpoint never trained is pruned
    relations = relations + [("u3", "nobody", 1.0), ("ghost", "u1", 1.0)]
    return data, relations


def _assert_csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def test_relation_matches_jax(social, tiny_graph_dataset):
    data, relations = social
    jdata = JaxInteraction(None, *tiny_graph_dataset)
    assert data.user == jdata.user
    rel, jrel = Relation(None, relations, data.user), JaxRelation(None, relations, jdata.user)
    assert rel.relation == jrel.relation and len(rel.relation) == len(relations) - 2
    assert rel.size() == jrel.size()
    for name in ("get_social_mat", "get_birectional_social_mat", "get_mutual_social_mat"):
        _assert_csr_equal(getattr(rel, name)(), getattr(jrel, name)())
    # the reference's "bidirectional" matrix is S.multiply(S), kept verbatim
    s = rel.get_social_mat()
    _assert_csr_equal(rel.get_birectional_social_mat(), s.multiply(s))
    assert rel.weight("u0", rel.relation[0][1]) == 1.0 and rel.has_followee(*rel.relation[0][:2])


def test_scipy_motifs_equal_jax(social):
    data, relations = social
    rel = Relation(None, relations, data.user)
    for got, want in zip(motifs.mhcn_hypergraphs(rel.get_social_mat(), data.interaction_mat),
                         jax_motifs.mhcn_hypergraphs(rel.get_social_mat(),
                                                     data.interaction_mat)):
        _assert_csr_equal(got, want)
    bi = rel.get_birectional_social_mat()
    for got, want in zip(motifs.sept_views(bi, data.interaction_mat, data.user_num),
                         jax_motifs.sept_views(bi, data.interaction_mat, data.user_num)):
        _assert_csr_equal(got, want)


def _random_social(seed, n_u=40, n_i=55):
    S = sp.random(n_u, n_u, density=0.12, random_state=seed, format="csr")
    S.data[:] = 1.0
    S.setdiag(0)
    S.eliminate_zeros()
    Y = sp.random(n_u, n_i, density=0.15, random_state=seed + 1, format="csr")
    Y.data[:] = 1.0
    return S.astype(np.float32), Y.astype(np.float32)


@pytest.mark.parametrize("seed", [4, 9])
def test_device_mhcn_motifs_match_jax_and_scipy(seed):
    S, Y = _random_social(seed)
    got = motifs.mhcn_hypergraphs_device(S, Y, device="cpu")
    want = jax_motifs.mhcn_hypergraphs_device(S, Y)
    host = motifs.mhcn_hypergraphs(S, Y)
    for g, w, h in zip(got, want, host):
        assert g.dtype == torch.float32 and g.shape == (40, 40)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
        # integer motif counts: the dense products are exact in f32
        np.testing.assert_array_equal(g.numpy(), h.toarray())
        assert np.count_nonzero(g.numpy()) > 0


@pytest.mark.parametrize("seed", [4, 9])
def test_device_sept_views_match_jax_and_scipy(seed):
    S, Y = _random_social(seed)
    B = S.multiply(S.T)
    got = motifs.sept_views_device(B, Y, 40, device="cpu")
    want = jax_motifs.sept_views_device(B, Y, 40)
    host = motifs.sept_views(B, Y, 40)
    for g, w, h in zip(got, want, host):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), h.toarray(), rtol=1e-6, atol=1e-6)


def test_full_f32_matmul_scope_restores_the_callers_setting():
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with full_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (2^-7 of its binade)."""
    x = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.where(x > 0, x, 1.0)))
    return np.where(x > 0, 2.0 ** (e - 7), 2.0 ** -133)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(50, 60), (37, 37)])
def test_dense_mat_spmm_forward_and_grad_match_jax_vjp(monkeypatch, dtype, shape):
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", dtype)
    rng = np.random.default_rng(3)
    m, n = shape
    a = sp.random(m, n, density=0.3, random_state=2, format="csr", dtype=np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    g = rng.normal(size=(m, 16)).astype(np.float32)
    jadj = jax_dense.dense_mat_from_scipy(a)
    jout, vjp = jax.vjp(lambda v: jax_dense.dense_mat_spmm(jadj, v), jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(g))
    tadj = spmm_dense.dense_mat_from_scipy(a, device="cpu")
    assert tadj.a.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tadj.a.float().numpy(),
                                  np.asarray(jadj.a.astype(jnp.float32)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t_graph.spmm(tadj, xt)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    grad = xt.grad.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(grad, np.asarray(jgrad), rtol=1e-5, atol=1e-6)
        return
    # bf16: every element of both gradients is a bf16 value, and they agree
    # within one bf16 ulp (two f32 sums a few bits apart may round apart)
    jg = np.asarray(jgrad)
    for v in (grad, jg):
        np.testing.assert_array_equal(torch.tensor(v).bfloat16().float().numpy(), v)
    assert np.all(np.abs(grad - jg) <= _bf16_ulp(jg))
    # one rounding of an f32 sum: within one ulp of the exact product of the
    # block's bf16 values and the f32 cotangent
    exact = tadj.a.double().numpy().T @ g.astype(np.float64)
    assert np.all(np.abs(grad - exact) <= _bf16_ulp(exact))


def test_dense_mat_from_scipy_rounds_each_value_before_the_add(monkeypatch):
    """Duplicate COO entries sum after each is rounded to the block's dtype,
    as JAX's ``.astype(dtype)`` before ``.at[].add`` does."""
    monkeypatch.delenv("SELFREC_TPU_DENSE_DTYPE", raising=False)
    rows = np.array([0, 0, 1, 2, 2, 2])
    cols = np.array([1, 1, 0, 2, 2, 2])
    vals = np.array([1.003, 1.003, 0.5, 0.3337, 0.3337, 0.3337], np.float32)
    coo = sp.coo_matrix((vals, (rows, cols)), shape=(3, 3))
    got = spmm_dense.dense_mat_from_scipy(coo, device="cpu").a
    want = jax_dense.dense_mat_from_scipy(coo).a
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_mat_rows_are_16_byte_aligned(monkeypatch, dtype):
    """A block whose row length is not a multiple of 16 bytes (R at douban
    scale has 22,345 columns) is stored at a 16-byte row pitch, so cuBLAS
    can take its aligned GEMMs; its values and products are unchanged."""
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", dtype)
    a = sp.random(30, 45, density=0.3, random_state=6, format="csr", dtype=np.float32)
    for adj in (spmm_dense.dense_mat_from_scipy(a, device="cpu"),
                DenseMat(torch.from_numpy(a.toarray()).to(getattr(torch, dtype)))):
        t = adj.a
        assert t.shape == (30, 45) and t.stride(1) == 1
        assert (t.stride(0) * t.element_size()) % 16 == 0 and t.stride(0) > 45
        np.testing.assert_array_equal(t.float().numpy(),
                                      torch.from_numpy(a.toarray()).to(t.dtype).float().numpy())
        x = torch.ones((45, 4))
        np.testing.assert_allclose(spmm_dense.dense_mat_spmm(adj, x).numpy(),
                                   t.float().numpy() @ np.ones((45, 4), np.float32), rtol=1e-6)


def test_union_ell_template_matches_jax_and_packs_two_encodes(social):
    data, relations = social
    rel = Relation(None, relations, data.user)
    views = motifs.sept_views(rel.get_birectional_social_mat(), data.interaction_mat,
                              data.user_num)
    tmpl, w = t_graph.union_ell_template(list(views), device="cpu")
    jtmpl, jw = jax_graph.union_ell_template(list(views))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tmpl.fwd.vidx.numpy(), np.asarray(jtmpl.fwd.vidx))
    np.testing.assert_array_equal(tmpl.bwd.vidx.numpy(), np.asarray(jtmpl.bwd.vidx))
    assert w.shape[0] == 2 and bool((w == 0).any()), "a view lacks some union edges"
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(data.user_num, 8))
                         .astype(np.float32))
    packed = t_graph.spmm_packed(tmpl, w, torch.cat([x, x], dim=1), 2)
    for i, v in enumerate(views):
        alone = t_graph.spmm(t_graph.norm_adj_from_scipy(v, device="cpu"), x)
        np.testing.assert_allclose(packed[:, 8 * i: 8 * (i + 1)].numpy(), alone.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode,budget_gb,expect", [
    ("0", None, "EllAdj"), ("1", None, "DenseMat"), ("auto", None, "EllAdj"),
    ("1", "0.000001", "EllAdj")])
def test_dense_general_gate_follows_jax(monkeypatch, social, mode, budget_gb, expect):
    """SELFREC_TPU_DENSE: 0 never, 1 when the block fits the budget, auto
    only on the card (here the CPU)."""
    data, relations = social
    monkeypatch.setenv("SELFREC_TPU_DENSE", mode)
    if budget_gb is not None:
        monkeypatch.setenv("SELFREC_TPU_DENSE_BUDGET_GB", budget_gb)
    r = Relation(None, relations, data.user).get_social_mat()
    n = data.user_num
    assert (t_graph.dense_general_available(n, n, "cpu")
            == jax_graph.dense_general_available(n, n) == (expect == "DenseMat"))
    tadj = t_graph.norm_adj_from_scipy(r, device="cpu", dense_general=True)
    jadj = jax_graph.norm_adj_from_scipy(r, dense_general=True)
    assert type(tadj).__name__ == type(jadj).__name__ == expect
    if expect == "DenseMat":
        assert isinstance(tadj, DenseMat) and tadj.shape == (n, n)


def test_dense_general_auto_takes_the_card_where_it_fits(monkeypatch):
    monkeypatch.setenv("SELFREC_TPU_DENSE", "auto")
    assert t_graph.dense_general_available(100, 100, "cuda")
    assert not t_graph.dense_general_available(100, 100, "cpu")
    monkeypatch.setenv("SELFREC_TPU_DENSE_BUDGET_GB", "0.00001")
    assert not t_graph.dense_general_available(100, 100, "cuda")


def test_session_loads_social_data(tmp_path, tiny_graph_dataset):
    """SelfRecTorch reads ``social.data`` as the JAX session does and hands
    it to the model, which trains and ranks through the whole pipeline."""
    from selfrec_tpu.data import io as jax_io
    from selfrec_tpu_torch.config import ModelConf
    from selfrec_tpu_torch.session import SelfRecTorch

    train, test = tiny_graph_dataset
    paths = {}
    for name, rows in (("train", train), ("test", test), ("social", social_relations())):
        paths[name] = str(tmp_path / f"{name}.txt")
        with open(paths[name], "w") as f:
            f.writelines(f"{a} {b} {w}\n" for a, b, w in rows)
    conf = ModelConf({
        "training.set": paths["train"], "test.set": paths["test"],
        "social.data": paths["social"], "model": {"name": "MHCN", "type": "graph"},
        "item.ranking.topN": [5], "embedding.size": 8, "max.epoch": 1, "batch.size": 64,
        "learning.rate": 0.01, "reg.lambda": 0.0001, "output": str(tmp_path / "out"),
        "seed": 1, "MHCN": {"n_layer": 1, "ss_rate": 0.01}})
    session = SelfRecTorch(conf, device="cpu")
    assert session.kwargs["social.data"] == jax_io.load_social_data(paths["social"])
    rec = session.execute()
    assert len(rec) == len({u for u, _, _ in test})
    assert any(f.endswith("-performance.txt") for f in os.listdir(tmp_path / "out"))
