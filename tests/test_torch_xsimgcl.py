"""XSimGCL of the port against the JAX package: perturbed_propagate, one
training step (loss, grads, Adam) and the clean eval embeddings, on the
dense block in bf16 and in int8 mode (JAX's Pallas kernel in interpret
mode), and the ELL layout.

Both packages start from the same weights (selfrec_tpu_torch.convert), see
the same batch and negatives, and the port is handed the per-hop noise
that JAX draws from its key (``split(key, n_layers)``, then
``uniform(keys[k], (n, D))``, graph.py:160-163).

Tolerances in every mode are those of tests/test_torch_simgcl.py: loss
rtol 1e-5, grads rtol 1e-4 / atol 1e-7 (bf16 mode: see
:data:`BF16_GRAD_SHARE`), params after one Adam step atol 1e-6,
embeddings rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models.graph.xsimgcl import XSimGCL as JaxXSimGCL
from selfrec_tpu.ops.graph import perturbed_propagate as jax_perturbed
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.ops import dense_dual, ell_gather
from selfrec_tpu_torch.ops.graph import perturbed_propagate

N_LAYERS, EMB, BATCH, LR = 3, 16, 64, 0.01
MODES = ["bfloat16", "int8", "ell"]


def _conf_dict():
    return {
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "XSimGCL", "type": "graph"},
        "item.ranking.topN": [10, 20], "embedding.size": EMB, "max.epoch": 1,
        "batch.size": BATCH, "learning.rate": LR, "reg.lambda": 0.0001,
        "output": "unused", "seed": 42,
        "XSimGCL": {"n_layer": N_LAYERS, "l_star": 1, "lambda": 0.2, "eps": 0.2,
                    "tau": 0.15},
    }


def set_mode(monkeypatch, mode):
    """The layout and matmul mode of both packages: the dense block in bf16
    or int8 (JAX's Pallas kernel in interpret mode), the ELL layout, or the
    edge-list NormAdj (``edgelist``: ``SELFREC_TPU_ELL=0``)."""
    if mode in ("ell", "edgelist"):
        monkeypatch.setenv("SELFREC_TPU_DENSE", "0")
        if mode == "edgelist":
            monkeypatch.setenv("SELFREC_TPU_ELL", "0")
        return
    monkeypatch.setenv("SELFREC_TPU_DENSE", "1")
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", mode)
    if mode == "int8":
        monkeypatch.setenv("SELFREC_TPU_DUAL", "1")
        monkeypatch.setenv("SELFREC_TPU_DUAL_INTERPRET", "1")


def _models(monkeypatch, dataset, mode):
    set_mode(monkeypatch, mode)
    train, test = dataset
    jm = JaxXSimGCL(JaxConf(_conf_dict()), train, test)
    jm.build()
    tm = get_model_class("XSimGCL")(ModelConf(_conf_dict()), train, test, device="cpu")
    tm.build()
    tm.set_params(convert.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()},
                                          device="cpu"))
    assert type(jm.adj).__name__ == type(tm.adj).__name__
    return jm, tm


def padded_batch(data, seed=0, n_valid=50):
    """A padded batch of BATCH rows: ``n_valid`` (user, item) edges, then
    padding rows."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(data.edge_users), n_valid, replace=False)
    u = np.zeros(BATCH, np.int64)
    i = np.zeros(BATCH, np.int64)
    u[:n_valid] = data.edge_users[pick]
    i[:n_valid] = data.edge_items[pick]
    j = rng.integers(0, data.item_num, BATCH)
    mask = (np.arange(BATCH) < n_valid).astype(np.float32)
    return {"u": u, "i": i, "j": j, "mask": mask}


def _jax_noise(key, n, d):
    keys = jax.random.split(key, N_LAYERS)
    return [np.array(jax.random.uniform(keys[k], (n, d), dtype=jnp.float32))
            for k in range(N_LAYERS)]


def adam_step(jm, batch, key, lr=LR):
    """JAX's loss, grads and params after one optax.adam step."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(jm.batch_loss))(jm.params, jb, key)
    opt = optax.adam(lr)
    updates, _ = opt.update(grads, opt.init(jm.params), jm.params)
    new = optax.apply_updates(jm.params, updates)
    return (float(loss), {k: np.asarray(v) for k, v in grads.items()},
            {k: np.asarray(v) for k, v in new.items()})


def torch_step(tm, batch, **fed):
    """The trainer's own step with the negatives and the draws (keyword
    arguments of the model's batch_loss) fed in."""
    cls = type(tm)
    tm.sample_negatives = lambda users: torch.from_numpy(batch["j"])
    tm.batch_loss = lambda params, b, generator=None: cls.batch_loss(
        tm, params, b, generator, **fed)
    loss = tm.train_step({"u": torch.from_numpy(batch["u"]),
                          "i": torch.from_numpy(batch["i"]),
                          "mask": torch.from_numpy(batch["mask"])})
    grads = {k: v.grad.numpy().copy() for k, v in tm.params.items()}
    new = {k: v.detach().numpy().copy() for k, v in tm.params.items()}
    return float(loss), grads, new


# Every mode at the tolerances above, but for one bf16 step in the grads:
# in bf16 mode both packages round each hop's scaled operand to bf16 and sum
# exact products in f32 (the port through K1's float kernel's function,
# ROADMAP.md §3.2), and the backward rounds the f32 product of the
# cotangent to bf16. Two f32 sums a few ulps apart can round to neighbouring
# bf16 values, so in bf16 mode the grads' atol is BF16_GRAD_SHARE of the
# largest grad (measured: 0 beyond the f32 tolerances for XSimGCL and
# DirectAU, 2^-10.4 for MixGCF). In every mode the params are compared where
# |grad| > 1e-6: Adam's first step lr * g / (|g| + eps) has the slope
# eps / (|g| + eps)^2, which turns a 3e-11 grad difference at |g| = 4e-8
# into a 1e-6 parameter difference (tests/test_torch_lightgcn.py).
BF16_GRAD_SHARE = 2.0 ** -9


def assert_close(mode, got, want, what, exact_tol):
    """``got`` against ``want`` at ``exact_tol`` (rtol, atol); in bf16 mode
    a grad's atol is at least BF16_GRAD_SHARE of ``want``'s largest
    magnitude. Returns the atol."""
    rtol, atol = exact_tol
    if mode == "bfloat16" and what == "grad":
        atol = max(atol, BF16_GRAD_SHARE * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return atol


def check_step(mode, jax_out, torch_out):
    (jl, jg, jp), (tl, tg, tp) = jax_out, torch_out
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in jg:
        atol = assert_close(mode, tg[k], jg[k], "grad", (1e-4, 1e-7))
        sure = np.abs(jg[k]) > max(2 * atol, 1e-6)
        assert sure.mean() > 0.3
        np.testing.assert_allclose(tp[k][sure], jp[k][sure], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cl_layer", [0, 1, None])
def test_perturbed_propagate_matches_jax(monkeypatch, tiny_graph_dataset, mode, cl_layer):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, mode)
    key = jax.random.PRNGKey(5)
    ego = np.concatenate([np.asarray(jm.params["user_emb"]),
                          np.asarray(jm.params["item_emb"])])
    noise = _jax_noise(key, *ego.shape)
    jout = jax_perturbed(jm.adj, jnp.asarray(ego), N_LAYERS, key, 0.2, cl_layer=cl_layer)
    tout = perturbed_propagate(tm.adj, torch.from_numpy(ego), N_LAYERS, 0.2,
                               cl_layer=cl_layer, noise=[torch.from_numpy(x) for x in noise])
    if cl_layer is None:
        jout, tout = (jout,), (tout,)
    else:
        assert len(tout) == 2
    for j, t in zip(jout, tout):
        assert_close(mode, t.numpy(), np.asarray(j), "value", (1e-5, 1e-6))
    if cl_layer == 0:  # the ego embedding itself
        assert np.array_equal(tout[1].numpy(), ego)


def test_perturbed_propagate_draws_one_uniform_a_hop(tiny_graph_dataset, monkeypatch):
    """Without ``noise`` the hop-k draw is the generator's k-th (n, D)
    ``torch.rand``, in hop order."""
    _, tm = _models(monkeypatch, tiny_graph_dataset, "ell")
    ego = torch.cat([tm.params["user_emb"], tm.params["item_emb"]]).detach()
    drawn = perturbed_propagate(tm.adj, ego, N_LAYERS, 0.2,
                                generator=torch.Generator().manual_seed(9), cl_layer=2)
    gen = torch.Generator().manual_seed(9)
    fed = [torch.rand(ego.shape, generator=gen) for _ in range(N_LAYERS)]
    again = perturbed_propagate(tm.adj, ego, N_LAYERS, 0.2, noise=fed, cl_layer=2)
    for a, b in zip(drawn, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_one_step_matches_jax(monkeypatch, tiny_graph_dataset, mode):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, mode)
    batch = padded_batch(tm.data)
    key = jax.random.PRNGKey(3)
    noise = _jax_noise(key, tm.data.user_num + tm.data.item_num, EMB)
    launches = (dense_dual.dual_matmul.launches, ell_gather.ell_gather_sum.launches)
    jax_out = adam_step(jm, batch, key)
    torch_out = torch_step(tm, batch, noise=[torch.from_numpy(x) for x in noise])
    # CPU: the plain versions, no kernel launch
    assert (dense_dual.dual_matmul.launches, ell_gather.ell_gather_sum.launches) == launches
    check_step(mode, jax_out, torch_out)


@pytest.mark.parametrize("mode", MODES)
def test_eval_embeddings_are_the_clean_pass(monkeypatch, tiny_graph_dataset, mode):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, mode)
    ju, ji = jm.compute_embeddings(jm.params)
    tu, ti = tm.embeddings()
    assert_close(mode, tu.numpy(), np.asarray(ju), "value", (1e-5, 1e-6))
    assert_close(mode, ti.numpy(), np.asarray(ji), "value", (1e-5, 1e-6))


def test_padding_rows_do_not_change_the_loss(monkeypatch, tiny_graph_dataset):
    _, tm = _models(monkeypatch, tiny_graph_dataset, "ell")
    batch = {k: torch.from_numpy(v) for k, v in padded_batch(tm.data).items()}
    n = tm.data.user_num + tm.data.item_num
    gen = torch.Generator().manual_seed(2)
    noise = [torch.rand(n, EMB, generator=gen) for _ in range(N_LAYERS)]
    a = tm.batch_loss(tm.params, batch, noise=noise)
    other = dict(batch)
    for k in ("u", "i", "j"):
        other[k] = batch[k].clone()
        other[k][batch["mask"] == 0] = 7
    assert torch.allclose(a, tm.batch_loss(tm.params, other, noise=noise), rtol=1e-6, atol=0)
