"""SGL of the port against the JAX package, in both arms, plus the layout
gate that picks the arm.

Both packages start from the same weights (selfrec_tpu_torch.convert), draw
the same per-epoch keep masks (``epoch_rng(epoch, stream=1)``) and see the
same batch and negatives. Compared: the keep masks and view weights, the
propagated embeddings, ``batch_loss``, its grads and the parameters after
one Adam step.

- ELL arm (``SELFREC_TPU_DENSE=0``): the three views run as one packed
  width-3D chain through K2's plain version here.
- dense arm (``SELFREC_TPU_DENSE=1``, ``SELFREC_TPU_DENSE_DTYPE=float32``):
  per-epoch ``refactor_view`` blocks and f32 matmuls.

Tolerances, as tests/test_torch_simgcl.py states them: loss rtol 1e-5,
grads rtol 1e-4 / atol 1e-7 (f32 sums in another order), parameters after
Adam's first step atol 1e-6; view weights rtol 1e-6; masks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models.graph.sgl import SGL as JaxSGL
from selfrec_tpu.ops import graph as jax_graph
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models.graph.sgl import SGL
from selfrec_tpu_torch.ops import graph as t_graph
from selfrec_tpu_torch.ops.spmm_dense import DenseAdj
from selfrec_tpu_torch.ops import spmm_ell as t_ell
from selfrec_tpu_torch.ops.spmm_ell import EllAdj

EMB, BATCH, LR = 16, 64, 0.01
ARMS = {"ell": {"SELFREC_TPU_DENSE": "0"},
        "dense": {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "float32"}}


def _conf_dict(aug_type=1):
    return {
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "SGL", "type": "graph"},
        "item.ranking.topN": [10, 20], "embedding.size": EMB, "max.epoch": 1,
        "batch.size": BATCH, "learning.rate": LR, "reg.lambda": 0.0001,
        "output": "unused", "seed": 42,
        "SGL": {"n_layer": 2, "lambda": 0.1, "drop_rate": 0.1,
                "aug_type": aug_type, "temp": 0.2},
    }


def _batch(data, seed=0):
    """A padded batch: 50 valid (user, item) edges, 14 padding rows."""
    rng = np.random.default_rng(seed)
    n_valid = 50
    pick = rng.choice(len(data.edge_users), n_valid, replace=False)
    u = np.zeros(BATCH, np.int32)
    i = np.zeros(BATCH, np.int32)
    u[:n_valid] = data.edge_users[pick]
    i[:n_valid] = data.edge_items[pick]
    j = rng.integers(0, data.item_num, BATCH).astype(np.int32)
    mask = (np.arange(BATCH) < n_valid).astype(np.float32)
    return {"u": u, "i": i, "j": j, "mask": mask}


def _params_np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _models(monkeypatch, dataset, arm, aug_type=1):
    for k, v in ARMS[arm].items():
        monkeypatch.setenv(k, v)
    train, test = dataset
    jm = JaxSGL(JaxConf(_conf_dict(aug_type)), train, test)
    jm.build()
    tm = SGL(ModelConf(_conf_dict(aug_type)), train, test, device="cpu")
    tm.build()
    tm.set_params(convert.params_from_jax(_params_np(jm.params), device="cpu"))
    assert isinstance(tm.adj, EllAdj if arm == "ell" else DenseAdj)
    assert type(tm.adj).__name__ == type(jm.adj).__name__
    return jm, tm


@pytest.mark.parametrize("aug_type", [0, 1])
def test_keep_masks_and_view_weights_identical(monkeypatch, tiny_graph_dataset,
                                               aug_type):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, "ell", aug_type)
    for epoch in (0, 3):
        jk = jm._edge_keep_mask(jm.epoch_rng(epoch, stream=1))
        tk = tm._edge_keep_mask(tm.epoch_rng(epoch, stream=1))
        np.testing.assert_array_equal(tk, jk)
        assert 0 < tk.sum() < len(tk)
        jaux = jm.epoch_setup(epoch)
        taux = tm.epoch_setup(epoch)
        for k in ("w1", "w2"):
            np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                       rtol=1e-6, atol=0)
        assert not np.array_equal(taux["w1"].numpy(), taux["w2"].numpy())


def _jax_step(jm, batch, aux, key):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["aux"] = aux
    loss, grads = jax.jit(jax.value_and_grad(jm.batch_loss))(jm.params, jb, key)
    opt = optax.adam(LR)
    updates, _ = opt.update(grads, opt.init(jm.params), jm.params)
    return float(loss), _params_np(grads), _params_np(optax.apply_updates(jm.params, updates))


def _torch_step(tm, batch):
    """The trainer's own step with the negatives injected."""
    j = torch.from_numpy(batch["j"]).long()
    tm.sample_negatives = lambda users: j
    loss = tm.train_step({"u": torch.from_numpy(batch["u"]).long(),
                          "i": torch.from_numpy(batch["i"]).long(),
                          "mask": torch.from_numpy(batch["mask"])})
    grads = {k: v.grad.numpy().copy() for k, v in tm.params.items()}
    new = {k: v.detach().numpy().copy() for k, v in tm.params.items()}
    return float(loss), grads, new


@pytest.mark.parametrize("arm", ["ell", "dense"])
def test_one_step_matches_jax(monkeypatch, tiny_graph_dataset, arm):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, arm)
    jaux = jm.epoch_setup(1)
    tm.aux = tm.epoch_setup(1)
    if arm == "dense":
        assert tm._view1.factored and tm._view2.factored
        np.testing.assert_array_equal(tm._view1.a_ui.numpy(), np.asarray(jm._view1.a_ui))
        np.testing.assert_allclose(tm._view2.row_scale.numpy(),
                                   np.asarray(jm._view2.row_scale), rtol=1e-6)
    batch = _batch(tm.data)
    jl, jg, jp = _jax_step(jm, batch, jaux, jax.random.PRNGKey(3))
    tl, tg, tp = _torch_step(tm, batch)
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-6)


def _stack_route(self, params, aux):
    """``SGL._propagated_views`` handing the packed product the (3, E)
    weight stack each step, so that every call builds its slot weights."""
    ego = self._ego(params)
    w_stack = torch.stack([self._w_clean, aux["w1"], aux["w2"]])
    x = torch.cat([ego, ego, ego], dim=1)
    acc = x
    for _ in range(self.n_layers):
        x = t_graph.spmm_packed(self._view_template, w_stack, x, 3)
        acc = acc + x
    out = acc / (self.n_layers + 1)
    d = self.emb_size
    return out[:, :d], out[:, d: 2 * d], out[:, 2 * d:]


def _ell_epochs(monkeypatch, dataset, n_epochs=2, n_steps=3):
    """A fresh ELL-arm SGL trained ``n_steps`` steps in each of ``n_epochs``
    epochs through the trainer's runner: (model, losses, params after each
    epoch, each epoch's aux and slot weights, the count of ``ell_weights``
    scatters after each epoch's set-up and after its steps)."""
    monkeypatch.setenv("SELFREC_TPU_DENSE", "0")
    train, test = dataset
    tm = SGL(ModelConf(_conf_dict()), train, test, device="cpu")
    tm.build()
    assert isinstance(tm._view_template, EllAdj)
    scattered = []

    def counted(layout, edge_w, scatter=t_ell.ell_weights):
        scattered.append(layout)
        return scatter(layout, edge_w)

    losses, params, auxes, slots, built = [], [], [], [], []
    with monkeypatch.context() as m:
        m.setattr(t_ell, "ell_weights", counted)
        for epoch in range(n_epochs):
            users, items, masks = tm.epoch_batches(epoch)
            assert users.shape[0] >= n_steps
            tm.begin_epoch(epoch)
            built.append(len(scattered))
            losses.append(tm.train_batches(users[:n_steps], items[:n_steps],
                                           masks[:n_steps]))
            built.append(len(scattered))
            params.append({k: v.detach().clone() for k, v in tm.params.items()})
            auxes.append(dict(tm.aux))
            slots.append(tm._slots)
    return tm, losses, params, (auxes, slots), built


def test_ell_steps_on_prebuilt_slot_weights_equal_the_stack_route(monkeypatch,
                                                                  tiny_graph_dataset):
    """Two epochs of three steps on the slot weights that ``epoch_setup``
    built: losses and parameters equal, bit for bit, a run whose
    ``_propagated_views`` hands each step the (3, E) stack."""
    _, losses, params, _, _ = _ell_epochs(monkeypatch, tiny_graph_dataset)
    monkeypatch.setattr(SGL, "_propagated_views", _stack_route)
    _, want_losses, want_params, _, want_built = _ell_epochs(monkeypatch, tiny_graph_dataset)
    assert want_built[-1] > 4  # the stack route scatters in every call
    for got, want in zip(losses, want_losses):
        assert torch.equal(got, want)
    for got, want in zip(params, want_params):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert not torch.equal(params[0]["user_emb"], params[1]["user_emb"])


def test_ell_slot_weights_are_each_epochs_stack(monkeypatch, tiny_graph_dataset):
    """Each epoch's slot weights are ``ell_weights`` of that epoch's
    (clean, view 1, view 2) stack over the template's two layouts, hold no
    autograd history, change with the epoch, and stay out of the aux."""
    tm, _, _, (auxes, slots), _ = _ell_epochs(monkeypatch, tiny_graph_dataset)
    tmpl = tm._view_template
    for epoch, (aux, pair) in enumerate(zip(auxes, slots)):
        assert set(aux) == {"w1", "w2"}
        stack = torch.stack([tm._w_clean, aux["w1"], aux["w2"]])
        for got, first, layout in zip(pair, slots[0], (tmpl.fwd, tmpl.bwd)):
            assert not got.requires_grad
            assert torch.equal(got, t_ell.ell_weights(layout, stack))
            assert epoch == 0 or not torch.equal(got, first)


def test_ell_slot_weights_are_built_once_an_epoch(monkeypatch, tiny_graph_dataset):
    """Each epoch's set-up scatters one block per layout of the template,
    and its steps (the runner's warm-up and steps) scatter none."""
    *_, built = _ell_epochs(monkeypatch, tiny_graph_dataset)
    assert built == [2, 2, 4, 4]


@pytest.mark.parametrize("arm", ["ell", "dense"])
def test_compute_embeddings_match_jax(monkeypatch, tiny_graph_dataset, arm):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, arm)
    ju, ji = jm.compute_embeddings(jm.params)
    tu, ti = tm.embeddings()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode,budget_gb,expect", [
    ("0", None, "EllAdj"), ("1", None, "DenseAdj"), ("auto", None, "EllAdj"),
    ("1", "0.000001", "EllAdj")])
def test_layout_gate_follows_jax(monkeypatch, tiny_graph_dataset, mode, budget_gb,
                                 expect):
    """SELFREC_TPU_DENSE: 0 never dense, 1 dense when the block fits the
    budget, auto dense only on the card (here the CPU: ELL)."""
    from selfrec_tpu_torch.data.interaction import Interaction

    monkeypatch.setenv("SELFREC_TPU_DENSE", mode)
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "float32")
    if budget_gb is not None:
        monkeypatch.setenv("SELFREC_TPU_DENSE_BUDGET_GB", budget_gb)
    train, test = tiny_graph_dataset
    data = Interaction(ModelConf(_conf_dict()), train, test)
    tadj = t_graph.norm_adj_from_scipy(data.norm_adj, data.user_num, device="cpu")
    jadj = jax_graph.norm_adj_from_scipy(data.norm_adj, n_users=data.user_num)
    assert type(tadj).__name__ == type(jadj).__name__ == expect
    if expect == "EllAdj":
        # the unified layout is the JAX package's, with K from SELFREC_TPU_ELL_K
        np.testing.assert_array_equal(tadj.fwd.vidx.numpy(), np.asarray(jadj.fwd.vidx))
        assert tadj.fwd.k == 16
