"""SEPT of the port against the JAX package, on both arms:

- ELL (``SELFREC_TPU_DENSE=0``): the rec and dropped views packed over the
  bipartite template, the social and sharing views over their union
  template, each pair one chain at P = 2 (K2's plain version here);
- dense (``SELFREC_TPU_DENSE=1``, ``SELFREC_TPU_DENSE_DTYPE=float32``): the
  views as DenseMat, the rec chain on the factored block, the epoch's
  dropped view through ``refactor_view``.
- int8 (``SELFREC_TPU_DENSE_DTYPE=int8``, the dense arm the card runs; JAX's
  Pallas kernel in interpret mode): the rec chain and the dropped view
  through K1's int8 function, the social views as bf16 DenseMat.

Both packages start from the same weights, draw the same keep mask
(``epoch_rng(epoch, stream=1)``) and see the same batch and negatives.
Compared: the keep mask and the dropped view, the warm and the joint
``batch_loss`` and their grads, and the pseudo-positives' tie order.

Tolerances: loss rtol 1e-5, grads rtol 1e-4 / atol 1e-6 (f32 sums in
another order; the joint phase's exp(cos / 0.1) scales the last bits of a
logit by 10, and one user-table element of 960 cancels to 4e-5 with
2.4e-7 of such noise); view weights rtol 1e-6; masks, blocks and top-k ids
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models.graph.sept import SEPT as JaxSEPT
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models.graph.sept import SEPT
from selfrec_tpu_torch.ops.spmm_dense import DenseAdj, DenseMat
from selfrec_tpu_torch.ops.spmm_ell import EllAdj
from selfrec_tpu_torch.utils import metrics

from _social_data import SEPT_EXTRA, padded_batch, social_conf_dict, social_relations

ARMS = {"ell": {"SELFREC_TPU_DENSE": "0"},
        "dense": {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "float32"},
        "int8": {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "int8",
                 "SELFREC_TPU_DUAL": "1", "SELFREC_TPU_DUAL_INTERPRET": "1"}}


def _models(monkeypatch, dataset, arm, **top):
    for k, v in ARMS[arm].items():
        monkeypatch.setenv(k, v)
    train, test = dataset
    conf = social_conf_dict("SEPT", SEPT_EXTRA, max_epoch=9, **top)
    kw = {"social.data": social_relations()}
    jm = JaxSEPT(JaxConf(conf), train, test, **kw)
    jm.build()
    tm = SEPT(ModelConf(conf), train, test, device="cpu", **kw)
    tm.build()
    tm.set_params(convert.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()},
                                          device="cpu"))
    if arm == "ell":
        assert isinstance(tm.adj, EllAdj) and tm._social_d1 is None
        np.testing.assert_array_equal(tm._social_w_stack.numpy(),
                                      np.asarray(jm._social_w_stack))
    else:
        assert isinstance(tm.adj, DenseAdj) and isinstance(tm._social_d1, DenseMat)
        assert (tm.adj.mm_dtype == torch.int8) == (arm == "int8")
        for got, want in ((tm._social_d1, jm._social_d1), (tm._social_d2, jm._social_d2)):
            np.testing.assert_allclose(got.a.float().numpy(),
                                       np.asarray(want.a).astype(np.float32), rtol=1e-6,
                                       atol=1e-7)
    return jm, tm


def _joint(jm, tm, epoch):
    jm._joint_phase = True
    tm.enter_phase(epoch)
    assert tm._joint_phase
    return jm.epoch_setup(epoch), tm.epoch_setup(epoch)


@pytest.mark.parametrize("arm", list(ARMS))
def test_epoch_setup_draws_jax_keep_mask_and_view(monkeypatch, tiny_graph_dataset, arm):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, arm)
    assert tm.epoch_setup(1) == {}  # the warm phase draws nothing
    jaux, taux = _joint(jm, tm, 5)
    if arm == "ell":
        np.testing.assert_allclose(taux["aug_w"].numpy(), np.asarray(jaux["aug_w"]),
                                   rtol=1e-6, atol=0)
        assert int((taux["aug_w"] == 0).sum()) > 0
    else:
        assert taux == {} and tm._aug_view.factored
        np.testing.assert_array_equal(tm._aug_view.a_ui.numpy(),
                                      np.asarray(jm._aug_view.a_ui))
        np.testing.assert_allclose(tm._aug_view.row_scale.numpy(),
                                   np.asarray(jm._aug_view.row_scale), rtol=1e-6)


def _compare_step(jm, tm, batch, jaux):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["aux"] = jaux
    jloss, jgrads = jax.value_and_grad(jm.batch_loss)(jm.params, jb, jax.random.PRNGKey(0))
    tb = {k: torch.tensor(v).long() if k != "mask" else torch.tensor(v)
          for k, v in batch.items()}
    tb["aux"] = tm.aux
    params = {k: v.detach().clone().requires_grad_(True) for k, v in tm.params.items()}
    loss = tm.batch_loss(params, tb)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrads[k]), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("arm", list(ARMS))
def test_warm_phase_loss_and_grads_match_jax(monkeypatch, tiny_graph_dataset, arm):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, arm)
    tm.enter_phase(0)
    assert not tm._joint_phase
    tm.aux = tm.epoch_setup(0)
    _compare_step(jm, tm, padded_batch(tm.data, 64, 50), {})


@pytest.mark.parametrize("n_valid", [50, 3])
@pytest.mark.parametrize("arm", list(ARMS))
def test_joint_phase_loss_and_grads_match_jax(monkeypatch, tiny_graph_dataset, arm,
                                              n_valid):
    """n_valid 3: at most 3 valid columns against ins_cnt 5, so each view's
    top-5 pseudo-positives include masked columns tied at exactly 0."""
    jm, tm = _models(monkeypatch, tiny_graph_dataset, arm)
    jaux, tm.aux = _joint(jm, tm, 4)
    _compare_step(jm, tm, padded_batch(tm.data, 64, n_valid, seed=n_valid), jaux)


def test_pseudo_positives_break_ties_as_lax_top_k(monkeypatch, tiny_graph_dataset):
    """The same label distributions through the port's pseudo-positive vote
    and through ``lax.top_k``: equal ids, though whole rows tie (masked
    columns at exactly 0, and repeated values among the valid ones)."""
    _, tm = _models(monkeypatch, tiny_graph_dataset, "ell")
    rng = np.random.default_rng(4)
    n = 64
    valid = np.arange(n) < 3  # fewer valid columns than ins_cnt
    probs = {}
    for name in ("friend", "sharing", "rec"):
        p = np.where(valid[None, :], rng.integers(1, 4, (n, n)) / 8.0, 0.0)
        probs[name] = p.astype(np.float32)
    got = tm._pseudo_positives({k: torch.from_numpy(v) for k, v in probs.items()})
    pairs = (("sharing", "rec"), ("friend", "rec"), ("friend", "sharing"))
    for ids, (a, b) in zip(got, pairs):
        want = jax.lax.top_k(jnp.asarray((probs[a] + probs[b]) / 2), tm.instance_cnt)[1]
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
        assert set(ids[0, 3:].tolist()) == {3, 4}  # the ties, lowest index first


def _train(monkeypatch, dataset, arm):
    for k, v in ARMS[arm].items():
        monkeypatch.setenv(k, v)
    train, test = dataset
    conf = social_conf_dict("SEPT", SEPT_EXTRA, learning_rate=0.02, max_epoch=9)
    model = SEPT(ModelConf(conf), train, test, device="cpu",
                 **{"social.data": social_relations()})
    model.build()
    model.train()
    rec = model.test()
    return model, metrics.parse_measure(
        metrics.ranking_evaluation(model.data.test_set, rec, [10]))


def test_training_lands_in_the_jax_tests_band(monkeypatch, tiny_graph_dataset):
    """tests/test_social.py:174-235's bands: the joint phase ran, Recall@10
    above 0.2, and the dense arm in f32 within 2e-3 of ELL on every
    metric."""
    model, ell = _train(monkeypatch, tiny_graph_dataset, "ell")
    assert model._joint_phase and ell["Recall"] > 0.2
    model, dense = _train(monkeypatch, tiny_graph_dataset, "dense")
    assert isinstance(model._aug_view, DenseAdj)
    for k in ell:
        assert abs(ell[k] - dense[k]) < 2e-3, (k, ell[k], dense[k])
