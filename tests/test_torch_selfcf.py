"""SelfCF of the port against the JAX package: one trainer step (loss,
grads, Adam and the history buffers), the history update with padded
lanes, and the eval embeddings, in the dense bf16 mode the JAX package pins
SelfCF to (``SELFREC_TPU_DENSE=1``, bench.py:786-805) and on the ELL
layout. Small synthetic graph, D 16, 2 layers; both packages start from
the same weights and history buffers. Tolerances as
tests/test_torch_buir.py states them (``check_step``); the history rows
are the f32 online rows, compared at rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu_torch.ops import dense_dual
from tests.test_torch_buir import (EMB, check_step, jax_step, model_pair, padded_batch,
                                   torch_step)
from tests.test_torch_xsimgcl import assert_close

SELFCF_CONF = {"n_layer": 2, "tau": 0.05}
MODES = ["bfloat16", "ell"]


@pytest.mark.parametrize("mode", MODES)
def test_one_step_matches_jax(monkeypatch, mode):
    jm, tm = model_pair(monkeypatch, "SelfCF", SELFCF_CONF, mode)
    batch = padded_batch(tm.data, seed=1)
    launches = dense_dual.float_products.launches
    jax_out = jax_step(jm, batch, jax.random.PRNGKey(0))
    torch_out = torch_step(tm, batch)
    assert dense_dual.float_products.launches == launches  # CPU: the plain version
    check_step(mode, jax_out, torch_out)


@pytest.mark.parametrize("mode", MODES)
def test_history_update_matches_jax_including_padded_lanes(monkeypatch, mode):
    """batch_loss_aux writes the valid rows' online embeddings into the
    history, and the padded lanes into the last row (JAX's wrapped -1
    index); every other row keeps its draw."""
    jm, tm = model_pair(monkeypatch, "SelfCF", SELFCF_CONF, mode)
    batch = padded_batch(tm.data, seed=2, n_valid=40)
    jb = dict({k: jnp.asarray(v) for k, v in batch.items()}, aux=jm.aux)
    jloss, jaux = jm.batch_loss_aux(jm.params, jb, jax.random.PRNGKey(0))
    tb = dict({k: torch.from_numpy(v) for k, v in batch.items()}, aux=tm.aux)
    with torch.no_grad():
        tloss, taux = tm.batch_loss_aux(tm.params, tb)
        u_online, _ = tm._propagate(tm.params)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in ("u_his", "i_his"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), rtol=1e-5, atol=1e-6)
    rows = batch["u"][:40]
    np.testing.assert_array_equal(taux["u_his"][rows].numpy(), u_online[rows].numpy())
    last = tm.data.user_num - 1
    np.testing.assert_array_equal(taux["u_his"][last].numpy(),
                                  u_online[batch["u"][-1]].numpy())
    kept = np.setdiff1d(np.arange(last), rows)
    assert torch.equal(taux["u_his"][kept], tm.aux["u_his"][kept])


@pytest.mark.parametrize("mode", MODES)
def test_eval_embeddings_match_jax(monkeypatch, mode):
    jm, tm = model_pair(monkeypatch, "SelfCF", SELFCF_CONF, mode)
    ju, ji = jm.compute_embeddings(jm.params)
    tu, ti = tm.embeddings()
    assert tu.shape == (tm.data.user_num, 2 * EMB)
    assert_close(mode, tu.numpy(), np.asarray(ju), "value", (1e-5, 1e-6))
    assert_close(mode, ti.numpy(), np.asarray(ji), "value", (1e-5, 1e-6))


def test_history_buffers_are_drawn_standard_normal_after_the_params(monkeypatch):
    """build() draws u_his, then i_his, standard normal from the step
    generator right after the params (the JAX package splits its key)."""
    from selfrec_tpu_torch.config import ModelConf
    from selfrec_tpu_torch.models import get_model_class
    from tests.test_torch_buir import conf_dict, small_graph

    monkeypatch.setenv("SELFREC_TPU_DENSE", "0")
    train, test = small_graph()
    tm = get_model_class("SelfCF")(ModelConf(conf_dict("SelfCF", SELFCF_CONF)), train,
                                   test, device="cpu")
    tm.build()
    gen = torch.Generator().manual_seed(tm.seed)
    tm.init_params(gen)
    u = torch.randn((tm.data.user_num, EMB), generator=gen)
    assert torch.equal(tm.aux["u_his"], u)
    assert tm.aux["i_his"].shape == (tm.data.item_num, EMB)
    assert abs(float(tm.aux["i_his"].std()) - 1.0) < 0.05
    assert set(tm.params) == {"user_emb", "item_emb", "predictor.w", "predictor.b"}
