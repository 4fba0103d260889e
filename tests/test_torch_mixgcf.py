"""MixGCF of the port against the JAX package: the candidates chosen at
each layer, one training step (loss, grads, Adam) in bf16, int8 and ELL
modes, the draw order, and the eval embeddings.

Both packages start from the same weights, batch and (B, n_negs)
negatives; the port is handed the keep masks and alphas that JAX draws
from its key (``split(key)`` into k_drop, k_mix; ``bernoulli(keys[k],
0.9, (n, D))`` over ``split(k_drop, n_layers)``; ``uniform(mix_keys[k],
(B, n_negs, D))`` over ``split(k_mix, n_layers + 1)``, mixgcf.py:48-79).
Tolerances as tests/test_torch_xsimgcl.py states them (``check_step``).

The argmax over 64 mixed candidates can flip on a near-tie when the two
packages sum in another order: a row's choice may differ only where JAX's
best score leads its runner-up by less than twice the largest difference
between the packages' scores of one candidate. Those rows are excluded
(none in any mode, at most 1% allowed), and every other row's choice must
be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models.graph.mixgcf import MixGCF as JaxMixGCF
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from tests.test_torch_xsimgcl import (BATCH, MODES, adam_step, assert_close, check_step,
                                      padded_batch, set_mode, torch_step)

N_LAYERS, N_NEGS = 2, 64


def _conf_dict():
    return {
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "MixGCF", "type": "graph"},
        "item.ranking.topN": [10, 20], "embedding.size": 16, "max.epoch": 1,
        "batch.size": BATCH, "learning.rate": 0.01, "reg.lambda": 0.0001,
        "output": "unused", "seed": 3, "MixGCF": {"n_layer": N_LAYERS, "n_negs": N_NEGS},
    }


def _models(monkeypatch, dataset, mode):
    set_mode(monkeypatch, mode)
    train, test = dataset
    jm = JaxMixGCF(JaxConf(_conf_dict()), train, test)
    jm.build()
    tm = get_model_class("MixGCF")(ModelConf(_conf_dict()), train, test, device="cpu")
    tm.build()
    tm.set_params(convert.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()},
                                          device="cpu"))
    assert type(jm.adj).__name__ == type(tm.adj).__name__
    return jm, tm


def _batch(data):
    """A padded batch with (B, n_negs) negatives, none equal to its row's
    positive (the sampler never draws a rated item): a negative equal to
    the positive mixes into the positive whatever its alpha, and two such
    candidates tie exactly."""
    batch = padded_batch(data, seed=6, n_valid=48)
    j = np.random.default_rng(8).integers(0, data.item_num, (BATCH, N_NEGS))
    batch["j"] = np.where(j == batch["i"][:, None], (j + 1) % data.item_num, j)
    return batch


def _jax_draws(key, n, d):
    k_drop, k_mix = jax.random.split(key)
    keys = jax.random.split(k_drop, N_LAYERS)
    mix_keys = jax.random.split(k_mix, N_LAYERS + 1)
    masks = [np.array(jax.random.bernoulli(keys[k], 0.9, (n, d))) for k in range(N_LAYERS)]
    alphas = [np.array(jax.random.uniform(mix_keys[k], (BATCH, N_NEGS, d)))
              for k in range(N_LAYERS + 1)]
    return masks, alphas


def _jax_scores(jm, batch, key, alphas):
    """JAX's (B, n_negs) candidate scores at each layer: mixgcf.py:67-81."""
    k_drop, _ = jax.random.split(key)
    user_layers, item_layers = jm._layerwise(jm.params, k_drop)
    u_emb = jnp.mean(jnp.stack(user_layers), axis=0)[batch["u"]]
    scores = []
    for k in range(N_LAYERS + 1):
        mixed = (alphas[k] * item_layers[k][batch["i"]][:, None, :]
                 + (1.0 - alphas[k]) * item_layers[k][batch["j"]])
        scores.append(np.asarray(jnp.sum(u_emb[:, None, :] * mixed, axis=-1)))
    return scores


def _fed(masks, alphas):
    return {"drop_masks": [torch.from_numpy(m) for m in masks],
            "alphas": [torch.from_numpy(a) for a in alphas]}


@pytest.mark.parametrize("mode", MODES)
def test_chosen_candidates_match_jax(monkeypatch, tiny_graph_dataset, mode):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, mode)
    batch = _batch(tm.data)
    key = jax.random.PRNGKey(1)
    masks, alphas = _jax_draws(key, tm.data.user_num + tm.data.item_num, 16)
    jscores = _jax_scores(jm, {k: jnp.asarray(v) for k, v in batch.items()}, key, alphas)
    fed = _fed(masks, alphas)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        user_layers, item_layers = tm._layerwise(tm.params, fed["drop_masks"])
        u_emb = torch.mean(torch.stack(user_layers), dim=0)[tb["u"]]
        _, tpicks = tm.mix_negatives(u_emb, item_layers, tb, fed["alphas"])
        tscores = [torch.sum(u_emb[:, None, :] * (a * item_layers[k][tb["i"]][:, None, :]
                                                  + (1.0 - a) * item_layers[k][tb["j"]]),
                             dim=-1).numpy() for k, a in enumerate(fed["alphas"])]
    assert len(tpicks) == N_LAYERS + 1
    excluded = 0
    for t, js, ts in zip(tpicks, jscores, tscores):
        top2 = np.sort(js, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * np.abs(ts - js).max()
        excluded += int((~clear).sum())
        np.testing.assert_array_equal(t.numpy()[clear], js.argmax(axis=1)[clear])
    assert excluded <= 0.01 * BATCH * (N_LAYERS + 1)


@pytest.mark.parametrize("mode", MODES)
def test_one_step_matches_jax(monkeypatch, tiny_graph_dataset, mode):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, mode)
    batch = _batch(tm.data)
    key = jax.random.PRNGKey(1)
    masks, alphas = _jax_draws(key, tm.data.user_num + tm.data.item_num, 16)
    jax_out = adam_step(jm, batch, key)
    torch_out = torch_step(tm, batch, **_fed(masks, alphas))
    check_step(mode, jax_out, torch_out)


def test_draws_follow_the_key_order(monkeypatch, tiny_graph_dataset):
    """Without fed draws the loss takes the keep masks, then the alphas, from
    the step generator (:meth:`MixGCF.draw`)."""
    _, tm = _models(monkeypatch, tiny_graph_dataset, "ell")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tm.data).items()}
    drawn = tm.batch_loss(tm.params, tb, torch.Generator().manual_seed(4))
    masks, alphas = tm.draw(torch.Generator().manual_seed(4), tb)
    assert len(masks) == N_LAYERS and masks[0].dtype == torch.bool
    assert len(alphas) == N_LAYERS + 1 and alphas[0].shape == (BATCH, N_NEGS, 16)
    assert 0.85 < float(masks[0].float().mean()) < 0.95
    assert torch.equal(drawn, tm.batch_loss(tm.params, tb, drop_masks=masks, alphas=alphas))


def test_trainer_samples_n_negs_per_pair(monkeypatch, tiny_graph_dataset):
    """The bitmap sampler draws a (B, n_negs) block of unrated items."""
    _, tm = _models(monkeypatch, tiny_graph_dataset, "ell")
    users = torch.from_numpy(padded_batch(tm.data)["u"])
    neg = tm.sample_negatives(users)
    assert neg.shape == (BATCH, N_NEGS)
    rated = {(int(u), int(i)) for u, i in zip(tm.data.edge_users, tm.data.edge_items)}
    hits = sum((int(u), int(j)) in rated for u, row in zip(users, neg) for j in row)
    assert hits <= 0.01 * neg.numel()


@pytest.mark.parametrize("mode", MODES)
def test_eval_embeddings_match_jax(monkeypatch, tiny_graph_dataset, mode):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, mode)
    ju, ji = jm.compute_embeddings(jm.params)
    tu, ti = tm.embeddings()
    assert_close(mode, tu.numpy(), np.asarray(ju), "value", (1e-5, 1e-6))
    assert_close(mode, ti.numpy(), np.asarray(ji), "value", (1e-5, 1e-6))
