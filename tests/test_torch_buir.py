"""BUIR of the port against the JAX package, and the per-step dropout it
runs on: ``DenseAdj.dropout_view`` and ``adj_dropout``.

Models run on a small synthetic graph (600 users, 900 items, D 16, 2
layers) in the dense bf16 mode that the JAX package pins BUIR to
(``SELFREC_TPU_DENSE=1``, bench.py:690-712), on the ELL layout, where
both chains run as one packed width-2D chain, and on the edge-list
``NormAdj`` (``SELFREC_TPU_ELL=0``), which packs nothing, so BUIR takes its
unpacked branch there as on the dense block. Both packages start from the
same weights and target tables; the port is handed the rates and keep
draws that JAX makes from its key (``split(key)`` into k_on, k_tg; each
``split`` into k_rate, k_keep; ``uniform(k_rate) * drop_rate`` and
``uniform(k_keep, E) >= rate``, buir.py:68-124).

Tolerances: loss rtol 1e-5; grads rtol 1e-4 / atol 1e-7 (bf16 mode: at
least 2^-9 of the largest grad, tests/test_torch_xsimgcl.py); params after
one Adam step atol 1e-6 where |grad| > 1e-5 (Adam's first step
lr * g / (|g| + eps) has the slope lr * eps / (|g| + eps)^2, 1e-3 at
|g| = 1e-5, so the grads' atol moves such a param by 1e-10 at most, where
at |g| = 1e-6 it could move it by 5e-6); target tables and embeddings
rtol 1e-5 / atol 1e-6. The dropped blocks and weights are compared exactly.
In int8 mode (NCL's) the backward quantizes the cotangent per channel, so
a last-bit difference in a sum can move one value across a rounding
boundary: at most 0.1% of the grads may leave rtol 1e-4 / atol 1e-7, none
by more than 1% of the largest grad (chip_smoke.py's rule for int8 card
against CPU), and those params are not compared.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models import get_model_class as jax_model_class
from selfrec_tpu.ops import graph as jax_graph
from selfrec_tpu.ops import spmm_dense as jax_dense
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.models.graph.buir import set_valid_rows
from selfrec_tpu_torch.ops import dense_dual, ell_gather
from selfrec_tpu_torch.ops import graph as t_graph
from selfrec_tpu_torch.ops import spmm_dense as t_dense
from selfrec_tpu_torch.utils.synth import synth_graph_triples
from tests.test_torch_xsimgcl import assert_close, set_mode

EMB, BATCH, LR = 16, 64, 0.01
BUIR_CONF = {"n_layer": 2, "drop_rate": 0.2, "tau": 0.995}


@functools.lru_cache(maxsize=None)
def small_graph():
    """(train, test) triples: 600 users, 900 items, 4,833 training edges."""
    return synth_graph_triples(600, 900, 6000, seed=11)


def conf_dict(name, extra, **top):
    conf = {"training.set": "<memory>", "test.set": "<memory>",
            "model": {"name": name, "type": "graph"}, "item.ranking.topN": [10, 20],
            "embedding.size": EMB, "max.epoch": 1, "batch.size": BATCH,
            "learning.rate": LR, "reg.lambda": 0.0001, "output": "unused", "seed": 3,
            name: extra}
    conf.update(top)
    return conf


def flat_np(tree):
    return {k: np.asarray(v) for k, v in convert.flatten_params(tree).items()}


def model_pair(monkeypatch, name, extra, mode, dataset=None, **top):
    """The JAX model and the port's, built in ``mode`` on ``dataset`` (the
    small graph by default), with JAX's weights and aux in both."""
    set_mode(monkeypatch, mode)
    train, test = dataset or small_graph()
    jm = jax_model_class(name)(JaxConf(conf_dict(name, extra, **top)), train, test)
    jm.build()
    tm = get_model_class(name)(ModelConf(conf_dict(name, extra, **top)), train, test,
                               device="cpu")
    tm.build()
    tm.set_params(convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                                          device="cpu"))
    tm.aux = {k: torch.from_numpy(np.array(v)) for k, v in jm.aux.items()}
    if hasattr(jm, "adj"):
        assert type(jm.adj).__name__ == type(tm.adj).__name__
    return jm, tm


def padded_batch(data, seed=0, n_valid=50):
    """BATCH rows: ``n_valid`` (user, item) edges, then padding rows that
    repeat the first edge's user and item (so a padded lane would collide
    with a valid one if it were written)."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(data.edge_users), n_valid, replace=False)
    u = np.full(BATCH, data.edge_users[pick[0]], np.int64)
    i = np.full(BATCH, data.edge_items[pick[0]], np.int64)
    u[:n_valid] = data.edge_users[pick]
    i[:n_valid] = data.edge_items[pick]
    j = rng.integers(0, data.item_num, BATCH)
    mask = (np.arange(BATCH) < n_valid).astype(np.float32)
    return {"u": u, "i": i, "j": j, "mask": mask}


def jax_step(jm, batch, key, aux=None):
    """JAX's trainer step (base.py:528-534): loss and new aux, grads, one
    optax.adam step, step_update. Returns flat numpy dicts."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["aux"] = jm.aux if aux is None else aux
    (loss, aux), grads = jax.jit(jax.value_and_grad(jm.batch_loss_aux, has_aux=True))(
        jm.params, jb, key)
    opt = optax.adam(LR)
    updates, _ = opt.update(grads, opt.init(jm.params), jm.params)
    new = optax.apply_updates(jm.params, updates)
    aux = jm.step_update(new, aux, jb)
    return (float(loss), flat_np(grads), flat_np(new),
            {k: np.asarray(v) for k, v in aux.items()})


def torch_step(tm, batch, **fed):
    """The port's trainer step with the negatives and the model's draws
    (keyword arguments of its batch_loss) fed in."""
    cls = type(tm)
    tm.sample_negatives = lambda users: torch.from_numpy(batch["j"])
    tm.batch_loss = lambda params, b, generator=None: cls.batch_loss(
        tm, params, b, generator, **fed)
    loss = tm.train_step({k: torch.from_numpy(batch[k]) for k in ("u", "i", "mask")})
    grads = {k: v.grad.numpy().copy() for k, v in tm.params.items()}
    new = {k: v.detach().numpy().copy() for k, v in tm.params.items()}
    return float(loss), grads, new, {k: v.numpy().copy() for k, v in tm.aux.items()}


def check_step(mode, jax_out, torch_out):
    """Loss, grads, params after Adam and aux, at the tolerances stated in
    the module docstring."""
    (jl, jg, jp, ja), (tl, tg, tp, ta) = jax_out, torch_out
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(tg) == set(jg)
    for k in jg:
        if mode == "int8":
            atol = 1e-7
            off = ~np.isclose(tg[k], jg[k], rtol=1e-4, atol=atol)
            assert off.mean() <= 1e-3, (k, int(off.sum()))
            assert np.abs(tg[k] - jg[k]).max() <= 1e-2 * np.abs(jg[k]).max(), k
        else:
            atol = assert_close(mode, tg[k], jg[k], "grad", (1e-4, 1e-7))
            off = np.zeros(jg[k].shape, bool)
        sure = (np.abs(jg[k]) > max(2 * atol, 1e-5)) & ~off
        assert sure.any(), k
        np.testing.assert_allclose(tp[k][sure], jp[k][sure], rtol=0, atol=1e-6)
    assert set(ta) == set(ja)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-5, atol=1e-6)


def jax_views(key, n_edges, drop_rate):
    """The (rate, keep) pairs JAX draws for the online and target views."""
    views = []
    for k in jax.random.split(key):
        k_rate, k_keep = jax.random.split(k)
        rate = jax.random.uniform(k_rate) * drop_rate
        keep = jax.random.uniform(k_keep, (n_edges,)) >= rate
        views.append((torch.tensor(np.asarray(rate)), torch.from_numpy(np.array(keep))))
    return views


MODES = ["bfloat16", "ell", "edgelist"]


@pytest.mark.parametrize("mode", MODES)
def test_one_step_matches_jax(monkeypatch, mode):
    jm, tm = model_pair(monkeypatch, "BUIR", BUIR_CONF, mode)
    batch = padded_batch(tm.data)
    key = jax.random.PRNGKey(4)
    views = jax_views(key, tm.adj.edge_w.shape[0], BUIR_CONF["drop_rate"])
    launches = (dense_dual.float_products.launches, ell_gather.ell_gather_sum.launches)
    jax_out = jax_step(jm, batch, key)
    torch_out = torch_step(tm, batch, views=views)
    assert (dense_dual.float_products.launches,
            ell_gather.ell_gather_sum.launches) == launches  # CPU: plain versions
    check_step(mode, jax_out, torch_out)


@pytest.mark.parametrize("mode", MODES)
def test_eval_embeddings_match_jax(monkeypatch, mode):
    jm, tm = model_pair(monkeypatch, "BUIR", BUIR_CONF, mode)
    ju, ji = jm.compute_embeddings(jm.params)
    tu, ti = tm.embeddings()
    assert tu.shape == (tm.data.user_num, 2 * EMB) and ti.shape == (tm.data.item_num, 2 * EMB)
    assert_close(mode, tu.numpy(), np.asarray(ju), "value", (1e-5, 1e-6))
    assert_close(mode, ti.numpy(), np.asarray(ji), "value", (1e-5, 1e-6))


def test_target_tables_start_as_copies_and_move_only_valid_rows(monkeypatch):
    """step_update moves the batch's valid rows by momentum tau, and the
    padded lanes write the last row as JAX's wrapped -1 index does; every
    other row is left as it was."""
    jm, tm = model_pair(monkeypatch, "BUIR", BUIR_CONF, "ell")
    assert torch.equal(tm.aux["t_user"], tm.params["user_emb"].detach())
    batch = padded_batch(tm.data, seed=5, n_valid=30)
    rng = np.random.default_rng(2)
    aux = {k: v + torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
           for k, v in tm.aux.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tm.step_update(tm.params, aux, tb)
    want = jm.step_update(jm.params, {k: jnp.asarray(v.numpy()) for k, v in aux.items()},
                          {k: jnp.asarray(v) for k, v in batch.items()})
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
    untouched = np.setdiff1d(np.arange(tm.data.user_num - 1), batch["u"][:30])
    assert torch.equal(got["t_user"][untouched], aux["t_user"][untouched])


def test_set_valid_rows_matches_jax_drop_mode_with_its_wrapped_index():
    """JAX's ``at[where(valid, idx, -1)].set(mode="drop")`` writes padded
    lanes into the last row (-1 is normalized, not dropped); the port
    matches it, and leaves its input as it was."""
    table = np.arange(12.0, dtype=np.float32).reshape(6, 2)
    idx = np.array([1, 4, 3, 0])
    rows = -np.arange(1.0, 9.0, dtype=np.float32).reshape(4, 2)
    valid = np.array([True, True, False, False])
    want = jnp.asarray(table).at[jnp.where(valid, idx, -1)].set(rows, mode="drop")
    src = torch.from_numpy(table.copy())
    out = set_valid_rows(src, torch.from_numpy(idx), torch.from_numpy(rows),
                         torch.from_numpy(valid))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert np.array_equal(np.asarray(want)[5], rows[3])  # the last padded lane's row
    assert torch.equal(src, torch.from_numpy(table))


def test_draws_follow_the_key_order(monkeypatch):
    """Without fed views the loss takes the online (rate, keep), then the
    target's, from the step generator (:meth:`BUIR.draw`)."""
    _, tm = model_pair(monkeypatch, "BUIR", BUIR_CONF, "ell")
    tb = dict({k: torch.from_numpy(v) for k, v in padded_batch(tm.data).items()}, aux=tm.aux)
    drawn = tm.batch_loss(tm.params, tb, torch.Generator().manual_seed(4))
    views = tm.draw(torch.Generator().manual_seed(4))
    assert len(views) == 2 and all(0 <= float(r) < 0.2 for r, _ in views)
    assert views[0][1].shape == tm.adj.edge_w.shape and views[0][1].dtype == torch.bool
    assert torch.equal(drawn, tm.batch_loss(tm.params, tb, views=views))


# -- dropout_view and adj_dropout -------------------------------------------

def _laplacian_pair(monkeypatch, dtype):
    """The dense block of the small graph's Laplacian in both packages, and
    the dataset's edges."""
    monkeypatch.setenv("SELFREC_TPU_DENSE", "1")
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", dtype)
    _, tm = model_pair(monkeypatch, "LightGCN", {"n_layer": 2}, "bfloat16")
    mat = tm.data.norm_adj
    jadj = jax_graph.norm_adj_from_scipy(mat, n_users=tm.data.user_num)
    tadj = t_graph.norm_adj_from_scipy(mat, tm.data.user_num, device="cpu")
    return jadj, tadj, tm.data


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_dropout_view_matches_jax_with_fed_keeps(monkeypatch, dtype):
    """A keep mask drawn in the dataset's edge order, permuted to the
    block's (adj_edge_perm), dropped in both packages: the same binary
    block and gain, B and the kept transpose still transposes, and the same
    propagation."""
    monkeypatch.setenv("SELFREC_TPU_DROPOUT_MASK", "scatter")
    jadj, tadj, data = _laplacian_pair(monkeypatch, dtype)
    perm = t_dense.adj_edge_perm(tadj, data.edge_users, data.edge_items, data.item_num)
    np.testing.assert_array_equal(
        perm, jax_dense.adj_edge_perm(jadj, data.edge_users, data.edge_items,
                                      data.item_num))
    keep_data = np.random.default_rng(3).random(data.n_edges) >= 0.3
    keep = keep_data[perm]
    rate = np.float32(0.3)
    # JAX's scatter mode draws keep = uniform(key, E) >= rate: feed it the
    # same mask by scattering it through a key-free reimplementation
    jview = jax_dense.DenseAdj(
        jadj.a_ui.at[jadj.edge_users, jadj.edge_items].multiply(jnp.asarray(keep, jnp.int8)),
        jadj.edge_users, jadj.edge_items, jadj.edge_w, jadj.n_users, jadj.n_items,
        jadj.row_scale, jadj.col_scale, jadj.gain * (1.0 / (1.0 - rate)),
        mm_dtype=jadj.mm_dtype)
    tview = tadj.dropout_view(torch.tensor(rate), keep=torch.from_numpy(keep))
    assert tview.factored and tview.mm_dtype == tadj.mm_dtype
    np.testing.assert_array_equal(tview.a_ui.numpy(), np.asarray(jview.a_ui))
    assert torch.equal(tview.a_iu, tview.a_ui.T)
    assert float(tview.gain) == float(jview.gain)
    assert int(tview.a_ui.sum()) == int(keep.sum())
    x = np.random.default_rng(4).normal(size=(tadj.n_nodes, EMB)).astype(np.float32)
    monkeypatch.setenv("SELFREC_TPU_DUAL", "1")
    monkeypatch.setenv("SELFREC_TPU_DUAL_INTERPRET", "1")
    jo = jax_dense.dense_spmm(jview, jnp.asarray(x))
    to = t_dense.dense_spmm(tview, torch.from_numpy(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    # the source block is left as it was
    assert int(tadj.a_ui.sum()) == data.n_edges and torch.equal(tadj.a_iu, tadj.a_ui.T)


def test_dropout_view_equals_jax_draw_for_the_same_key(monkeypatch):
    """JAX's own dropout_view (scatter mode on the CPU) against the port fed
    JAX's draw for that key."""
    jadj, tadj, _ = _laplacian_pair(monkeypatch, "bfloat16")
    key = jax.random.PRNGKey(9)
    rate = jnp.float32(0.25)
    jview = jadj.dropout_view(key, rate)
    keep = np.array(jax.random.uniform(key, jadj.edge_w.shape) >= rate)
    tview = tadj.dropout_view(torch.tensor(0.25), keep=torch.from_numpy(keep))
    np.testing.assert_array_equal(tview.a_ui.numpy(), np.asarray(jview.a_ui))
    assert float(tview.gain) == float(jview.gain)


def test_dropout_view_generic_block_multiplies_every_duplicate(monkeypatch):
    """A generic block (duplicate edges) drops per edge and scales by
    1 / (1 - rate) in the block's dtype, as spmm_dense.py:168-173 does."""
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "bfloat16")
    rng = np.random.default_rng(6)
    eu = rng.integers(0, 30, 200).astype(np.int32)
    ei = rng.integers(0, 40, 200).astype(np.int32)
    w = rng.uniform(0.1, 1.0, 200).astype(np.float32)
    jadj = jax_dense.dense_adj_from_edges(eu, ei, w, 30, 40)
    tadj = t_dense.dense_adj_from_edges(eu, ei, w, 30, 40, device="cpu")
    assert not jadj.factored and not tadj.factored
    key = jax.random.PRNGKey(2)
    jview = jadj.dropout_view(key, 0.4)
    keep = np.array(jax.random.uniform(key, jadj.edge_w.shape) >= 0.4)
    tview = tadj.dropout_view(0.4, keep=torch.from_numpy(keep))
    np.testing.assert_array_equal(tview.a_ui.float().numpy(),
                                  np.asarray(jview.a_ui.astype(jnp.float32)))


def test_adj_dropout_on_ell_matches_jax(monkeypatch):
    monkeypatch.setenv("SELFREC_TPU_DENSE", "0")
    _, tm = model_pair(monkeypatch, "LightGCN", {"n_layer": 2}, "ell")
    mat = tm.data.norm_adj
    jadj = jax_graph.norm_adj_from_scipy(mat, n_users=tm.data.user_num)
    tadj = t_graph.norm_adj_from_scipy(mat, tm.data.user_num, device="cpu")
    key = jax.random.PRNGKey(3)
    rate = jnp.float32(0.15)
    jview = jax_graph.adj_dropout(jadj, key, rate)
    keep = np.array(jax.random.uniform(key, jadj.edge_w.shape) >= rate)
    tview = t_graph.adj_dropout(tadj, torch.tensor(0.15), keep=torch.from_numpy(keep))
    np.testing.assert_array_equal(tview.edge_w.numpy(), np.asarray(jview.edge_w))
    np.testing.assert_array_equal(tview.w_fwd.numpy(), np.asarray(jview.w_fwd))
    np.testing.assert_array_equal(tview.w_bwd.numpy(), np.asarray(jview.w_bwd))
    x = np.random.default_rng(1).normal(size=(mat.shape[0], EMB)).astype(np.float32)
    np.testing.assert_allclose(t_graph.spmm(tview, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_graph.spmm(jview, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError, match="adj_dropout over object"):
        t_graph.adj_dropout(object(), 0.1)


def test_dropout_draws_keep_from_the_generator(monkeypatch):
    _, tadj, _ = _laplacian_pair(monkeypatch, "bfloat16")
    view = tadj.dropout_view(0.3, generator=torch.Generator().manual_seed(8))
    keep = torch.rand(tadj.edge_w.shape, generator=torch.Generator().manual_seed(8)) >= 0.3
    assert torch.equal(view.a_ui, tadj.dropout_view(0.3, keep=keep).a_ui)
    assert 0.65 < float(keep.float().mean()) < 0.75


@pytest.mark.parametrize("mode", ["fused", "rbg"])
def test_dropout_mask_other_than_scatter_is_refused(monkeypatch, mode):
    """The port draws the keep mask per edge only: the JAX package's
    per-position mask (``fused``) and any other value raise, naming
    ROADMAP.md, before anything is drawn."""
    _, tadj, _ = _laplacian_pair(monkeypatch, "bfloat16")
    monkeypatch.setenv("SELFREC_TPU_DROPOUT_MASK", mode)
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tadj.dropout_view(0.1, generator=gen)
    assert torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_blocks_at_a_ragged_width_are_pitched_for_k1(monkeypatch, dtype):
    """At an item count that is not a multiple of 16, the built block, its
    dropout view and its refactored view all hold B and Bᵀ at K1's 16-byte
    row pitch, so a launch reads them as they are and copies nothing."""
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", dtype)
    rng = np.random.default_rng(5)
    nu, ni = 50, 71
    key = np.unique(rng.integers(0, nu * ni, 400))
    eu, ei = (key // ni).astype(np.int32), (key % ni).astype(np.int32)
    du, di = np.bincount(eu, minlength=nu), np.bincount(ei, minlength=ni)
    w = (1.0 / np.sqrt(np.maximum(du[eu], 1) * np.maximum(di[ei], 1))).astype(np.float32)
    adj = t_dense.dense_adj_from_edges(eu, ei, w, nu, ni, device="cpu")
    assert adj.factored and adj.mm_dtype == getattr(torch, dtype)
    keep = torch.from_numpy(rng.random(len(eu)) >= 0.3)
    for blk in (adj, adj.dropout_view(0.3, keep=keep), adj.refactor_view(keep)):
        assert blk.a_ui.stride(0) == 80 and not blk.a_ui.is_contiguous()
        for t in (blk.a_ui, blk.a_iu):
            assert dense_dual._pitched(t) is t
        assert torch.equal(blk.a_iu, blk.a_ui.T)
    assert int(adj.a_ui.sum()) == len(eu)


def test_pitched_copy_keeps_the_pitch_and_owns_its_memory():
    """The dropout view's copy of the kept transpose: equal values, the same
    16-byte row pitch (one block copy with the padding), a fresh buffer."""
    b = (torch.rand((37, 53), generator=torch.Generator().manual_seed(0)) < 0.3).to(torch.int8)
    bt = dense_dual.block_transpose(b)
    assert bt.stride(0) == 48 and not bt.is_contiguous()
    copy = t_dense._pitched_copy(bt)
    assert torch.equal(copy, bt) and copy.stride() == bt.stride()
    assert copy.data_ptr() != bt.data_ptr()
    copy[0, 0] = 1 - copy[0, 0]
    assert not torch.equal(copy, bt)
    dense = torch.arange(12.0).reshape(3, 4)[:, 1:]  # not a pitched view: plain copy
    assert torch.equal(t_dense._pitched_copy(dense), dense)
