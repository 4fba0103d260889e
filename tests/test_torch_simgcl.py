"""One SimGCL training step of the port against the JAX package.

Both packages start from the same weights (selfrec_tpu_torch.convert), see
the same batch and negatives, and the port is handed the per-hop noise that
JAX draws from its key (keys split as ``split(key, 2 * n_layers)`` reshaped
to (n_layers, 2), graph.py:279-289). Compared: ``batch_loss``, its grads,
and the parameters after one Adam step (optax.adam vs torch.optim.Adam,
both eps 1e-8). The losses of ops/losses.py are compared on their own too.

Tolerances, the same in both modes:
- loss rtol 1e-5 and grads rtol 1e-4 / atol 1e-7: reductions (norms,
  softmax, matmul sums) run in another order in the two frameworks;
- parameters after the step atol 1e-6: Adam's first step is
  lr * g / (|g| + eps), insensitive to such grad errors.
In int8 mode each hop quantizes its operand, a step function, so a
last-bit difference could move one value by a quantum; at these inputs
both packages quantize the same operands, and the same tolerances hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models.graph.simgcl import SimGCL as JaxSimGCL
from selfrec_tpu.ops import losses as jax_losses
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models.graph.simgcl import SimGCL
from selfrec_tpu_torch.ops import dense_dual
from selfrec_tpu_torch.ops import losses as t_losses

N_LAYERS, EMB, BATCH, LR = 3, 16, 64, 0.01


def _conf_dict():
    return {
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "SimGCL", "type": "graph"},
        "item.ranking.topN": [10, 20], "embedding.size": EMB, "max.epoch": 1,
        "batch.size": BATCH, "learning.rate": LR, "reg.lambda": 0.0001,
        "output": "unused", "seed": 42,
        "SimGCL": {"n_layer": N_LAYERS, "lambda": 0.5, "eps": 0.1},
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


def _jax_noise(key, n, d):
    keys = jax.random.split(key, 2 * N_LAYERS).reshape(N_LAYERS, 2, -1)
    return [[np.array(jax.random.uniform(keys[k, j], (n, d), dtype=jnp.float32))
             for j in range(2)] for k in range(N_LAYERS)]


def _models(monkeypatch, dataset, dtype_name):
    monkeypatch.setenv("SELFREC_TPU_DENSE", "1")
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", dtype_name)
    if dtype_name == "int8":
        # JAX's Pallas kernel (interpret mode) for the width-48 packed chain
        monkeypatch.setenv("SELFREC_TPU_DUAL", "1")
        monkeypatch.setenv("SELFREC_TPU_DUAL_INTERPRET", "1")
    train, test = dataset
    jm = JaxSimGCL(JaxConf(_conf_dict()), train, test)
    jm.build()
    tm = SimGCL(ModelConf(_conf_dict()), train, test, device="cpu")
    tm.build()
    tm.set_params(convert.params_from_jax(convert_np(jm.params), device="cpu"))
    assert tm.adj.factored and tm.adj.mm_dtype == getattr(torch, dtype_name)
    return jm, tm


def convert_np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _jax_step(jm, batch, key):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(jm.batch_loss))(jm.params, jb, key)
    opt = optax.adam(LR)
    updates, _ = opt.update(grads, opt.init(jm.params), jm.params)
    new = optax.apply_updates(jm.params, updates)
    return float(loss), convert_np(grads), convert_np(new)


def _torch_step(tm, batch, noise):
    """The trainer's own step (negatives, loss and grads, Adam,
    step_update) with the negatives and the noise injected."""
    j = torch.from_numpy(batch["j"]).long()
    noise_t = [[torch.from_numpy(x) for x in pair] for pair in noise]
    tm.sample_negatives = lambda users: j
    tm.batch_loss = lambda params, b, generator=None: SimGCL.batch_loss(
        tm, params, b, generator, noise=noise_t)
    loss = tm.train_step({"u": torch.from_numpy(batch["u"]).long(),
                          "i": torch.from_numpy(batch["i"]).long(),
                          "mask": torch.from_numpy(batch["mask"])})
    grads = {k: v.grad.numpy().copy() for k, v in tm.params.items()}
    new = {k: v.detach().numpy().copy() for k, v in tm.params.items()}
    return float(loss), grads, new


@pytest.mark.parametrize("mode", ["float32", "int8"])
def test_one_step_matches_jax(monkeypatch, tiny_graph_dataset, mode):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, mode)
    batch = _batch(tm.data)
    key = jax.random.PRNGKey(3)
    n = tm.data.user_num + tm.data.item_num
    noise = _jax_noise(key, n, EMB)
    launches = dense_dual.dual_matmul.launches
    jl, jg, jp = _jax_step(jm, batch, key)
    tl, tg, tp = _torch_step(tm, batch, noise)
    assert dense_dual.dual_matmul.launches == launches  # CPU: no kernel launch
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-6)

def test_compute_embeddings_match_jax(monkeypatch, tiny_graph_dataset):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, "float32")
    ju, ji = jm.compute_embeddings(jm.params)
    tu, ti = tm.embeddings()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-6)


def test_padded_anchors_are_excluded(monkeypatch, tiny_graph_dataset):
    """Padding rows do not change the loss: they are masked as BPR rows
    and as InfoNCE anchors and negatives."""
    _, tm = _models(monkeypatch, tiny_graph_dataset, "float32")
    batch = {k: torch.from_numpy(v).long() if k != "mask" else torch.from_numpy(v)
             for k, v in _batch(tm.data).items()}
    n = tm.data.user_num + tm.data.item_num
    noise = [[torch.rand(n, EMB, generator=torch.Generator().manual_seed(2 * k + j))
              for j in range(2)] for k in range(N_LAYERS)]
    a = tm.batch_loss(tm.params, batch, noise=noise)
    other = dict(batch)
    for k in ("u", "i", "j"):
        other[k] = batch[k].clone()
        other[k][batch["mask"] == 0] = 7  # different padding content
    b = tm.batch_loss(tm.params, other, noise=noise)
    assert torch.allclose(a, b, rtol=1e-6, atol=0)


def _loss_inputs(seed=0, n=40, d=12):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(3)]
    mask = (np.arange(n) < 31).astype(np.float32)
    arrs[0][5] = 0.0  # an exactly-zero row: finite grads through l2_normalize
    return arrs, mask


@pytest.mark.parametrize("name", ["bpr", "l2_reg", "infonce", "infonce_unmasked"])
def test_losses_and_grads_match_jax(name):
    (a, b, c), mask = _loss_inputs()
    fns = {
        "bpr": (lambda L, x, y, z, m: L.bpr_loss(x, y, z, mask=m)),
        "l2_reg": (lambda L, x, y, z, m: L.l2_reg_loss(0.01, x, y, mask=m)),
        "infonce": (lambda L, x, y, z, m: L.infonce(x, y, 0.2, mask=m)),
        "infonce_unmasked": (lambda L, x, y, z, m: L.infonce(x, y, 0.2)),
    }
    f = fns[name]
    jv, jg = jax.value_and_grad(
        lambda x, y: f(jax_losses, x, y, jnp.asarray(c), jnp.asarray(mask)),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    x = torch.from_numpy(a).requires_grad_(True)
    y = torch.from_numpy(b).requires_grad_(True)
    tv = f(t_losses, x, y, torch.from_numpy(c), torch.from_numpy(mask))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jg[1]), rtol=1e-5, atol=1e-7)
    assert np.all(np.isfinite(x.grad.numpy()))
