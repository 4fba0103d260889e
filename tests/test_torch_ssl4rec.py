"""SSL4Rec of the port against the JAX package, and the pieces it adds:
``batch_softmax_loss``, ``torch_linear_params`` and ``linear_apply``.

One trainer step (loss, grads, Adam) with the dropout masks JAX draws from
its key (``split(key)`` into k1, k2; ``bernoulli(k, 1 - drop, (B, D))``,
ssl4rec.py:66-69), and the eval embeddings, on a small synthetic graph at
D 16 with the towers at their full widths (1024, 128). No adjacency.
Tolerances: loss rtol 1e-5, grads rtol 1e-4 / atol 1e-7, params after one
Adam step atol 1e-6 where |grad| > 1e-5 (tests/test_torch_buir.py says
why), embeddings and losses rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.ops import losses as jax_losses
from selfrec_tpu.ops.init import linear_apply as jax_linear_apply
from selfrec_tpu.ops.init import torch_linear_params as jax_linear_params
from selfrec_tpu_torch.ops import dense_dual, ell_gather, losses
from selfrec_tpu_torch.ops.init import linear_apply, torch_linear_params
from tests.test_torch_buir import (BATCH, EMB, check_step, jax_step, model_pair,
                                   padded_batch, torch_step)

SSL4REC_CONF = {"tau": 0.07, "alpha": 0.1, "drop": 0.1}


def _jax_masks(key, shape):
    k1, k2 = jax.random.split(key)
    return [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.9, shape))) for k in (k1, k2)]


def test_one_step_matches_jax(monkeypatch):
    jm, tm = model_pair(monkeypatch, "SSL4Rec", SSL4REC_CONF, "ell")
    assert not hasattr(tm, "adj")
    batch = padded_batch(tm.data, seed=3)
    key = jax.random.PRNGKey(6)
    launches = (dense_dual.dual_matmul.launches, dense_dual.float_products.launches,
                ell_gather.ell_gather_sum.launches)
    jax_out = jax_step(jm, batch, key)
    torch_out = torch_step(tm, batch, drop_masks=_jax_masks(key, (BATCH, EMB)))
    assert (dense_dual.dual_matmul.launches, dense_dual.float_products.launches,
            ell_gather.ell_gather_sum.launches) == launches
    check_step("float32", jax_out, torch_out)
    assert set(torch_out[1]) == {"user_emb", "item_emb", "user_tower.0.w", "user_tower.0.b",
                                 "user_tower.1.w", "user_tower.1.b", "item_tower.0.w",
                                 "item_tower.0.b", "item_tower.1.w", "item_tower.1.b"}


def test_eval_embeddings_match_jax(monkeypatch):
    jm, tm = model_pair(monkeypatch, "SSL4Rec", SSL4REC_CONF, "ell")
    ju, ji = jm.compute_embeddings(jm.params)
    tu, ti = tm.embeddings()
    assert tu.shape == (tm.data.user_num, 128) and ti.shape == (tm.data.item_num, 128)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-6)


def test_draws_follow_the_key_order(monkeypatch):
    _, tm = model_pair(monkeypatch, "SSL4Rec", SSL4REC_CONF, "ell")
    tb = {k: torch.from_numpy(v) for k, v in padded_batch(tm.data).items()}
    drawn = tm.batch_loss(tm.params, tb, torch.Generator().manual_seed(2))
    masks = tm.draw(torch.Generator().manual_seed(2), (BATCH, EMB), "cpu")
    assert len(masks) == 2 and masks[0].dtype == torch.bool
    assert 0.85 < float(masks[0].float().mean()) < 0.95
    assert torch.equal(drawn, tm.batch_loss(tm.params, tb, drop_masks=masks))


@pytest.mark.parametrize("masked", [False, True])
def test_batch_softmax_loss_matches_jax(masked):
    rng = np.random.default_rng(1)
    u = rng.normal(size=(48, 32)).astype(np.float32)
    i = rng.normal(size=(48, 32)).astype(np.float32)
    mask = (np.arange(48) < 30).astype(np.float32) if masked else None
    want = jax_losses.batch_softmax_loss(jnp.asarray(u), jnp.asarray(i), 0.07,
                                         mask=None if mask is None else jnp.asarray(mask))
    ut = torch.from_numpy(u).requires_grad_(True)
    got = losses.batch_softmax_loss(ut, torch.from_numpy(i), 0.07,
                                    mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got.backward()
    jg = jax.grad(lambda a: jax_losses.batch_softmax_loss(
        a, jnp.asarray(i), 0.07, mask=None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(u))
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-7)
    if masked:  # padded rows are neither anchors nor denominators
        other = i.copy()
        other[30:] = 5.0
        again = losses.batch_softmax_loss(torch.from_numpy(u), torch.from_numpy(other), 0.07,
                                          mask=torch.from_numpy(mask))
        np.testing.assert_allclose(float(again), float(got), rtol=1e-6)


def test_torch_linear_params_has_the_jax_bound_and_shape():
    """U[-1/sqrt(in), 1/sqrt(in)] for W (in, out) and b (out,), as the JAX
    initialiser (different draws), and linear_apply equals JAX's on the
    same weights."""
    t = torch_linear_params(torch.Generator().manual_seed(0), 64, 1024, device="cpu")
    j = jax_linear_params(jax.random.PRNGKey(0), 64, 1024)
    bound = 1.0 / 8.0
    for k in ("w", "b"):
        assert tuple(t[k].shape) == j[k].shape and t[k].dtype == torch.float32
        assert float(t[k].abs().max()) <= bound
    assert abs(float(t["w"].std()) - float(np.asarray(j["w"]).std())) < 0.02 * bound
    gen = torch.Generator().manual_seed(0)
    w = torch.rand((64, 1024), generator=gen)
    assert torch.equal(t["w"], w * (2 * bound) - bound)
    x = np.random.default_rng(0).normal(size=(5, 64)).astype(np.float32)
    p = {k: v.numpy() for k, v in t.items()}
    np.testing.assert_allclose(linear_apply(t, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_linear_apply(p, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError, match="device"):
        torch_linear_params(torch.Generator(), 4, 4)
