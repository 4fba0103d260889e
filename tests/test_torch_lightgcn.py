"""LightGCN of the port against the JAX package: one training step (loss,
grads, Adam) and the propagated embeddings, on the ELL layout (the CPU's
default under ``SELFREC_TPU_DENSE=auto``; K2's plain version, forward and
the transpose-layout backward), on the edge-list NormAdj
(``SELFREC_TPU_ELL=0``) and on the dense f32 block.

Same weights (selfrec_tpu_torch.convert), batch and negatives in both
packages. Tolerances as tests/test_torch_simgcl.py states them: loss rtol
1e-5, grads rtol 1e-4 / atol 1e-7, embeddings rtol 1e-5 / atol 1e-6.

Parameters after the step: Adam's first step is lr * g / (|g| + eps) with
eps 1e-8, whose slope eps / (|g| + eps)^2 turns a 3e-11 grad difference at
|g| = 4e-8 (rows the batch touches only through the ego L2 term) into a
1e-6 parameter difference. So the port's update must equal that step from
its own grads (atol 1e-7), and the parameters must agree with JAX's to
atol 1e-6 wherever |g| > 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models.graph.lightgcn import LightGCN as JaxLightGCN
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.ops import ell_gather
from selfrec_tpu_torch.ops.graph import NormAdj
from selfrec_tpu_torch.ops.spmm_dense import DenseAdj
from selfrec_tpu_torch.ops.spmm_ell import EllAdj

EMB, BATCH, LR, N_LAYERS = 16, 64, 0.01, 3


def _conf_dict():
    return {
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "LightGCN", "type": "graph"},
        "item.ranking.topN": [10, 20], "embedding.size": EMB, "max.epoch": 1,
        "batch.size": BATCH, "learning.rate": LR, "reg.lambda": 0.0001,
        "output": "unused", "seed": 7, "LightGCN": {"n_layer": N_LAYERS},
    }


def _models(monkeypatch, dataset, arm):
    if arm == "dense":
        monkeypatch.setenv("SELFREC_TPU_DENSE", "1")
        monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "float32")
    else:
        monkeypatch.delenv("SELFREC_TPU_DENSE", raising=False)
    if arm == "edgelist":
        monkeypatch.setenv("SELFREC_TPU_ELL", "0")
    train, test = dataset
    jm = JaxLightGCN(JaxConf(_conf_dict()), train, test)
    jm.build()
    tm = get_model_class("LightGCN")(ModelConf(_conf_dict()), train, test, device="cpu")
    tm.build()
    tm.set_params(convert.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()},
                                          device="cpu"))
    assert isinstance(tm.adj, {"ell": EllAdj, "edgelist": NormAdj, "dense": DenseAdj}[arm])
    assert type(jm.adj).__name__ == type(tm.adj).__name__
    return jm, tm


def _batch(data):
    rng = np.random.default_rng(1)
    pick = rng.choice(len(data.edge_users), 40, replace=False)
    u = np.zeros(BATCH, np.int64)
    i = np.zeros(BATCH, np.int64)
    u[:40], i[:40] = data.edge_users[pick], data.edge_items[pick]
    j = rng.integers(0, data.item_num, BATCH)
    return {"u": u, "i": i, "j": j, "mask": (np.arange(BATCH) < 40).astype(np.float32)}


@pytest.mark.parametrize("arm", ["ell", "edgelist", "dense"])
def test_one_step_matches_jax(monkeypatch, tiny_graph_dataset, arm):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, arm)
    batch = _batch(tm.data)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(jm.batch_loss))(jm.params, jb,
                                                        jax.random.PRNGKey(0))
    opt = optax.adam(LR)
    updates, _ = opt.update(jg, opt.init(jm.params), jm.params)
    jp = optax.apply_updates(jm.params, updates)

    tm.sample_negatives = lambda users: torch.from_numpy(batch["j"])
    before = {k: v.detach().numpy().copy() for k, v in tm.params.items()}
    launches = ell_gather.ell_gather_sum.launches
    tl = tm.train_step({"u": torch.from_numpy(batch["u"]), "i": torch.from_numpy(batch["i"]),
                        "mask": torch.from_numpy(batch["mask"])})
    assert ell_gather.ell_gather_sum.launches == launches  # CPU: plain version
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jg:
        g = tm.params[k].grad.numpy()
        new = tm.params[k].detach().numpy()
        np.testing.assert_allclose(g, np.asarray(jg[k]), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(new, before[k] - LR * g / (np.abs(g) + 1e-8),
                                   rtol=0, atol=1e-7)
        big = np.abs(np.asarray(jg[k])) > 1e-6
        assert big.mean() > 0.5
        np.testing.assert_allclose(new[big], np.asarray(jp[k])[big], rtol=0, atol=1e-6)


@pytest.mark.parametrize("arm", ["ell", "edgelist", "dense"])
def test_compute_embeddings_match_jax(monkeypatch, tiny_graph_dataset, arm):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, arm)
    ju, ji = jm.compute_embeddings(jm.params)
    tu, ti = tm.embeddings()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-6)


def test_session_trains_lightgcn_on_ell_and_beats_random(tmp_path, tiny_graph_dataset,
                                                         monkeypatch):
    """The session end to end on the CPU's default layout (ELL); random
    Recall@10 is about 10/60 = 0.17."""
    from selfrec_tpu_torch import SelfRecTorch
    from selfrec_tpu_torch.utils import metrics

    monkeypatch.delenv("SELFREC_TPU_DENSE", raising=False)
    conf = dict(_conf_dict(), **{"max.epoch": 6, "learning.rate": 0.05,
                                 "output": str(tmp_path), "item.ranking.topN": [10]})
    train, test = tiny_graph_dataset
    rec_list = SelfRecTorch(ModelConf(conf), device="cpu", training_data=train,
                            test_data=test).execute()
    perf = metrics.parse_measure(
        metrics.ranking_evaluation({u: {i: 1.0} for u, i, _ in test}, rec_list, [10]))
    assert perf["Recall"] > 0.2
