"""NCL of the port against the JAX package, in both phases: one trainer
step (loss, grads, Adam) and the eval embeddings, in the dense bf16 and int8
modes (JAX's Pallas kernel in interpret mode) and on the ELL layout. Small
synthetic graph, D 16, 3 layers, 10 clusters. In the prototype phase both
packages are handed the centroids and assignments that the JAX package's
k-means makes from its key (selfrec_tpu/ops/kmeans.py; the port's k-means
is held to it in tests/test_torch_kmeans.py). The phase flip of
``run_epoch`` is held with ``warm_up_epochs`` lowered, as
tests/test_models_e2e.py:160 does. Tolerances as tests/test_torch_buir.py
states them (``check_step``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.ops.kmeans import kmeans as jax_kmeans
from selfrec_tpu_torch.ops import dense_dual
from tests.test_torch_buir import (BATCH, EMB, check_step, jax_step, model_pair, padded_batch,
                                   torch_step)
from tests.test_torch_xsimgcl import assert_close

NCL_CONF = {"n_layer": 3, "ssl_reg": 1e-6, "proto_reg": 1e-7, "tau": 0.05,
            "hyper_layers": 1, "alpha": 1.5, "num_clusters": 10}
MODES = ["bfloat16", "int8", "ell"]


def _proto_aux(jm, key):
    """JAX's E-step on its raw tables (ncl.py:71-78), as numpy."""
    k1, k2 = jax.random.split(key)
    uc, u2c = jax_kmeans(k1, jm.params["user_emb"], NCL_CONF["num_clusters"])
    ic, i2c = jax_kmeans(k2, jm.params["item_emb"], NCL_CONF["num_clusters"])
    return {"user_cent": uc, "user2c": u2c, "item_cent": ic, "item2c": i2c}


@pytest.mark.parametrize("phase", ["warm", "proto"])
@pytest.mark.parametrize("mode", MODES)
def test_one_step_matches_jax(monkeypatch, mode, phase):
    jm, tm = model_pair(monkeypatch, "NCL", NCL_CONF, mode)
    batch = padded_batch(tm.data, seed=4)
    aux = {}
    if phase == "proto":
        jm._proto_phase = tm._proto_phase = True
        aux = _proto_aux(jm, jax.random.PRNGKey(8))
    tm.aux = {k: torch.from_numpy(np.array(v)) for k, v in aux.items()}
    launches = dense_dual.dual_matmul.launches
    jax_out = jax_step(jm, batch, jax.random.PRNGKey(0), aux=aux)
    torch_out = torch_step(tm, batch)
    assert dense_dual.dual_matmul.launches == launches  # CPU: the plain version
    check_step(mode, jax_out, torch_out)


@pytest.mark.parametrize("n_valid", [50, BATCH])
@pytest.mark.parametrize("loss", ["structural", "prototype"])
def test_layer_losses_and_grads_match_jax_unscaled(monkeypatch, loss, n_valid):
    """``_ssl_layer_loss`` and ``_proto_loss`` on their own, against JAX's
    functions of the same names on the same inputs, with ssl_reg =
    proto_reg = 1: at the production weights they are 1e-3 and 1e-4 of the
    step's loss, below what the whole step's check can see. Values at the
    loss rtol 1e-5; grads in (context, initial) at rtol 1e-4 and an atol of
    1e-6 of the largest grad (unscaled, the grads reach about 30, and the
    two packages sum a row's 1,500 exp terms in another order: f32 rounding
    moves a grad near zero by up to 5e-7 of the largest); padded lanes
    (n_valid < BATCH) must add nothing."""
    jm, tm = model_pair(monkeypatch, "NCL", dict(NCL_CONF, ssl_reg=1.0, proto_reg=1.0), "ell")
    batch = padded_batch(tm.data, seed=6, n_valid=n_valid)
    jaux = _proto_aux(jm, jax.random.PRNGKey(8))
    rng = np.random.default_rng(9)
    n = tm.data.user_num + tm.data.item_num
    context, initial = (rng.normal(size=(n, EMB)).astype(np.float32) for _ in range(2))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    taux = {k: torch.from_numpy(np.array(v)) for k, v in jaux.items()}
    if loss == "structural":
        jfn = lambda c, i: jm._ssl_layer_loss(c, i, jb)
        tfn = lambda c, i: tm._ssl_layer_loss(c, i, tb)
    else:
        jfn = lambda c, i: jm._proto_loss(i, jb, jaux) + 0.0 * jnp.sum(c)
        tfn = lambda c, i: tm._proto_loss(i, tb, taux) + 0.0 * torch.sum(c)
    jl, jg = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(context), jnp.asarray(initial))
    tc, ti = (torch.from_numpy(a).requires_grad_(True) for a in (context, initial))
    tl = tfn(tc, ti)
    tl.backward()
    assert float(tl.detach()) > 1.0  # an unscaled loss of its own size
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for got, want in ((tc.grad, jg[0]), (ti.grad, jg[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())
    touched = np.zeros(n, bool)
    touched[batch["u"][:n_valid]] = touched[tm.data.user_num + batch["i"][:n_valid]] = True
    if loss == "prototype":  # only the batch's own rows of initial get a grad
        assert not ti.grad.numpy()[~touched].any() and not tc.grad.any()


def test_proto_loss_is_added_only_in_the_proto_phase(monkeypatch):
    jm, tm = model_pair(monkeypatch, "NCL", NCL_CONF, "ell")
    aux = {k: torch.from_numpy(np.array(v))
           for k, v in _proto_aux(jm, jax.random.PRNGKey(8)).items()}
    tb = dict({k: torch.from_numpy(v) for k, v in padded_batch(tm.data).items()}, aux=aux)
    with torch.no_grad():
        warm = tm.batch_loss(tm.params, tb)
        tm._proto_phase = True
        proto = tm.batch_loss(tm.params, tb)
        _, layers = tm._propagate(tm.params)
        extra = tm._proto_loss(layers[0], tb, aux)
    assert float(extra) > 0
    torch.testing.assert_close(proto, warm + extra, rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_eval_embeddings_match_jax(monkeypatch, mode):
    jm, tm = model_pair(monkeypatch, "NCL", NCL_CONF, mode)
    ju, ji = jm.compute_embeddings(jm.params)
    tu, ti = tm.embeddings()
    assert_close(mode, tu.numpy(), np.asarray(ju), "value", (1e-5, 1e-6))
    assert_close(mode, ti.numpy(), np.asarray(ji), "value", (1e-5, 1e-6))


def test_run_epoch_flips_to_the_proto_phase_after_warm_up(monkeypatch):
    """With warm_up_epochs 1: epoch 0 trains without prototypes, epoch 1
    runs the E-step on the raw tables first (k centroids, int32
    assignments) and trains with them."""
    _, tm = model_pair(monkeypatch, "NCL", NCL_CONF, "ell")
    tm.warm_up_epochs = 1
    losses0 = tm.run_epoch(0)
    assert not tm._proto_phase and tm.aux == {}
    before = tm.params["user_emb"].detach().clone()
    gen_state = tm.generator.get_state()
    losses1 = tm.run_epoch(1)
    assert tm._proto_phase
    assert tm.aux["user_cent"].shape == (NCL_CONF["num_clusters"], EMB)
    assert tm.aux["item2c"].shape == (tm.data.item_num,)
    assert tm.aux["user2c"].dtype == torch.int32
    assert np.all(np.isfinite(losses0)) and np.all(np.isfinite(losses1))
    assert not torch.equal(tm.params["user_emb"], before)
    # the E-step's initial rows came from the step generator: replaying its
    # state before epoch 1 gives the same centroids for the same tables
    from selfrec_tpu_torch.ops.kmeans import kmeans

    gen = torch.Generator().set_state(gen_state)
    uc, _ = kmeans(before, NCL_CONF["num_clusters"], generator=gen)
    torch.testing.assert_close(uc, tm.aux["user_cent"], rtol=0, atol=0)
