"""MF of the port against the JAX package: the loss, one training step
(loss, grads, Adam) and the eval cadence. MF has no adjacency, so there is
one mode; tolerances as tests/test_torch_xsimgcl.py states them
(``check_step``)."""

import jax
import numpy as np
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models.graph.mf import MF as JaxMF
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.ops import dense_dual, ell_gather
from tests.test_torch_xsimgcl import BATCH, adam_step, check_step, padded_batch, torch_step


def _conf_dict(**extra):
    return dict({
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "MF", "type": "graph"},
        "item.ranking.topN": [10, 20], "embedding.size": 16, "max.epoch": 1,
        "batch.size": BATCH, "learning.rate": 0.01, "reg.lambda": 0.01,
        "output": "unused", "seed": 5,
    }, **extra)


def _models(dataset):
    train, test = dataset
    jm = JaxMF(JaxConf(_conf_dict()), train, test)
    jm.build()
    tm = get_model_class("MF")(ModelConf(_conf_dict()), train, test, device="cpu")
    tm.build()
    tm.set_params(convert.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()},
                                          device="cpu"))
    assert not hasattr(tm, "adj")
    return jm, tm


@pytest.mark.parametrize("n_valid", [BATCH, 37])
def test_loss_matches_jax(tiny_graph_dataset, n_valid):
    jm, tm = _models(tiny_graph_dataset)
    batch = padded_batch(tm.data, seed=n_valid, n_valid=n_valid)
    jl = float(jm.batch_loss(jm.params, {k: jax.numpy.asarray(v) for k, v in batch.items()},
                             None))
    tl = float(tm.batch_loss(tm.params, {k: torch.from_numpy(v) for k, v in batch.items()})
               .detach())
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


def test_one_step_matches_jax(tiny_graph_dataset):
    jm, tm = _models(tiny_graph_dataset)
    batch = padded_batch(tm.data, seed=2)
    launches = (dense_dual.dual_matmul.launches, ell_gather.ell_gather_sum.launches)
    jax_out = adam_step(jm, batch, jax.random.PRNGKey(0))
    torch_out = torch_step(tm, batch)
    assert (dense_dual.dual_matmul.launches, ell_gather.ell_gather_sum.launches) == launches
    check_step("float32", jax_out, torch_out)


def test_evaluates_every_fifth_epoch(tiny_graph_dataset):
    """fast_evaluation after epochs 1 and 6 of 7 (epoch % 5 == 0, MF.py:30),
    as the JAX package's MF."""
    train, test = tiny_graph_dataset
    conf = _conf_dict(**{"max.epoch": 7, "learning.rate": 0.05})
    tm = get_model_class("MF")(ModelConf(conf), train, test, device="cpu")
    jm = JaxMF(JaxConf(conf), train, test)
    assert [e for e in range(7) if tm.should_evaluate(e)] == [0, 5]
    assert [e for e in range(7) if jm.should_evaluate(e)] == [0, 5]
    tm.build()
    seen = []
    tm.fast_evaluation = lambda epoch: seen.append(epoch)
    tm.train()
    assert seen == [0, 5]


def test_eval_embeddings_do_not_move_with_the_tables(tiny_graph_dataset):
    """The embeddings MF ranks are the tables' values when they were taken,
    not views that Adam's in-place steps change."""
    _, tm = _models(tiny_graph_dataset)
    ue, ie = tm.embeddings()
    assert torch.equal(ue, tm.params["user_emb"]) and not ue.requires_grad
    before = ue.clone()
    tm.train_step({k: torch.from_numpy(v) for k, v in padded_batch(tm.data).items()
                   if k != "j"})
    assert torch.equal(ue, before) and not torch.equal(ue, tm.params["user_emb"])
