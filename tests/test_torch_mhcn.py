"""MHCN of the port against the JAX package, on the ELL arm and on DenseMat
in f32 and in bf16.

Both packages start from the same weights (``params_from_jax`` of JAX's
``init_params``) and see the same batch and negatives; the
self-supervision's shuffles are the permutations JAX draws from its key,
fed to the port (``batch_loss(..., perms=...)``). Compared: the forward
embeddings, ``_hierarchical_ss`` per channel, ``batch_loss`` and its grads.

Tolerances: f32 (ELL, DenseMat f32) embeddings rtol 1e-5 / atol 1e-6, the
loss and the self-supervision rtol 1e-5, grads rtol 1e-4 / atol 1e-6 (f32
sums in another order). bf16 DenseMat rounds each layer's operand to bf16,
so a sum a few f32 ulps off may round to the neighbouring bf16 value and
carry into the next layer: embeddings and grads within 2^-8 of the
tensor's largest magnitude, the loss rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models.graph.mhcn import MHCN as JaxMHCN
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models.graph.mhcn import MHCN
from selfrec_tpu_torch.ops.spmm_dense import DenseMat
from selfrec_tpu_torch.ops.spmm_ell import EllAdj
from selfrec_tpu_torch.utils import metrics

from _social_data import MHCN_EXTRA, padded_batch, social_conf_dict, social_relations

ARMS = {"ell": {"SELFREC_TPU_DENSE": "0"},
        "dense_f32": {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "float32"},
        "dense_bf16": {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": None}}


def _set_arm(monkeypatch, arm):
    for k, v in ARMS[arm].items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


def _models(monkeypatch, dataset, arm):
    _set_arm(monkeypatch, arm)
    train, test = dataset
    conf = social_conf_dict("MHCN", MHCN_EXTRA, learning_rate=0.02)
    kw = {"social.data": social_relations()}
    jm = JaxMHCN(JaxConf(conf), train, test, **kw)
    jm.build()
    tm = MHCN(ModelConf(conf), train, test, device="cpu", **kw)
    tm.build()
    tm.set_params(convert.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()},
                                          device="cpu"))
    kind = EllAdj if arm == "ell" else DenseMat
    for adj, jadj in zip(tm.H + [tm.R, tm.Rt], jm.H + [jm.R, jm.Rt]):
        assert isinstance(adj, kind) and type(jadj).__name__ == kind.__name__
    if arm != "ell":
        for adj, jadj in zip(tm.H + [tm.R, tm.Rt], jm.H + [jm.R, jm.Rt]):
            np.testing.assert_array_equal(adj.a.float().numpy(),
                                          np.asarray(jadj.a.astype(jnp.float32)))
    return jm, tm


def _channel_perms(key, n, d):
    """The permutations JAX's _hierarchical_ss draws from ``key``, in the
    order the port takes them (mhcn.py:153-165)."""
    k1, k2, k3, _ = jax.random.split(key, 4)
    ka, kb = jax.random.split(k2)
    kc, kd = jax.random.split(k3)
    return tuple(torch.tensor(np.asarray(jax.random.permutation(k, m))).long()
                 for k, m in ((k1, n), (ka, n), (kb, d), (kc, n), (kd, d)))


def _step_perms(key, n, d):
    return [_channel_perms(k, n, d) for k in jax.random.split(key, 3)]


def _close(arm, got, want, rtol=1e-5, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    if arm == "dense_bf16":
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -8 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("arm", list(ARMS))
def test_forward_matches_jax(monkeypatch, tiny_graph_dataset, arm):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, arm)
    ju, ji = jm.forward(jm.params)
    with torch.no_grad():
        tu, ti = tm.forward(tm.params)
    _close(arm, tu.numpy(), ju)
    _close(arm, ti.numpy(), ji)


@pytest.mark.parametrize("arm", list(ARMS))
def test_hierarchical_ss_with_fed_permutations_matches_jax(monkeypatch, tiny_graph_dataset,
                                                           arm):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, arm)
    rng = np.random.default_rng(2)
    em = rng.normal(size=(tm.data.user_num, tm.emb_size)).astype(np.float32)
    for c in range(3):
        key = jax.random.PRNGKey(10 + c)
        want = float(jm._hierarchical_ss(key, jnp.asarray(em), jm.H[c]))
        got = float(tm._hierarchical_ss(torch.from_numpy(em), tm.H[c],
                                        _channel_perms(key, tm.data.user_num, tm.emb_size)))
        np.testing.assert_allclose(got, want, rtol=1e-4 if arm == "dense_bf16" else 1e-5)


@pytest.mark.parametrize("arm", list(ARMS))
def test_batch_loss_and_grads_match_jax(monkeypatch, tiny_graph_dataset, arm):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, arm)
    batch = padded_batch(tm.data, 64, 50)
    key = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(jm.batch_loss)(jm.params, jb, key)
    tb = {k: torch.from_numpy(v).long() if k != "mask" else torch.from_numpy(v)
          for k, v in batch.items()}
    params = {k: v.detach().clone().requires_grad_(True) for k, v in tm.params.items()}
    loss = tm.batch_loss(params, tb, perms=_step_perms(key, tm.data.user_num, tm.emb_size))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4 if arm == "dense_bf16" else 1e-5)
    assert set(params) == set(jgrads)
    for k, v in params.items():
        _close(arm, v.grad.numpy(), jgrads[k], rtol=1e-4, atol=1e-6)


def test_params_from_jax_carries_the_flat_names(monkeypatch, tiny_graph_dataset):
    """MHCN's params are flat names; the conversion keeps them and their
    values both ways."""
    jm, tm = _models(monkeypatch, tiny_graph_dataset, "ell")
    jp = {k: np.asarray(v) for k, v in jm.params.items()}
    assert list(tm.params) == list(jp)
    assert len(jp) == 4 + 4 * 4 and "sgating_bias4" in jp
    back = convert.params_to_jax(tm.params)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], v)
    assert {k: tuple(v.shape) for k, v in tm.init_params(tm.generator).items()} == {
        k: v.shape for k, v in jp.items()}


def _train(monkeypatch, dataset, arm):
    _set_arm(monkeypatch, arm)
    train, test = dataset
    conf = social_conf_dict("MHCN", MHCN_EXTRA, learning_rate=0.02)
    model = MHCN(ModelConf(conf), train, test, device="cpu",
                 **{"social.data": social_relations()})
    model.build()
    model.train()
    rec = model.test()
    return model, metrics.parse_measure(
        metrics.ranking_evaluation(model.data.test_set, rec, [10]))


def test_training_lands_in_the_jax_tests_band(monkeypatch, tiny_graph_dataset):
    """tests/test_social.py:163-205's bands: Recall@10 above 0.2 on ELL,
    DenseMat f32 within 2e-3 of ELL on every metric, bf16 within 0.03."""
    _, ell = _train(monkeypatch, tiny_graph_dataset, "ell")
    assert ell["Recall"] > 0.2
    model, f32 = _train(monkeypatch, tiny_graph_dataset, "dense_f32")
    assert all(isinstance(h, DenseMat) for h in model.H)
    _, bf16 = _train(monkeypatch, tiny_graph_dataset, "dense_bf16")
    for k in ell:
        assert abs(ell[k] - f32[k]) < 2e-3, (k, ell[k], f32[k])
        assert abs(ell[k] - bf16[k]) < 0.03, (k, ell[k], bf16[k])
