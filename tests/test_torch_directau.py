"""DirectAU of the port against the JAX package: the alignment and
uniformity losses (values and grads), the uniformity against the
reference's exact-size ``torch.pdist`` over valid rows, the case of fewer
than two valid rows, and one training step in bf16, int8 and ELL modes.

Tolerances: losses alone rtol 1e-6 / atol 1e-7, grads rtol 1e-4 / atol
1e-7 (the model steps' grad tolerance of tests/test_torch_simgcl.py: the
pair terms are summed in another order, and the grad of the exactly-zero
row goes through l2_normalize's clamp, a factor of 1e12); the step as
tests/test_torch_xsimgcl.py states them (``check_step``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models.graph.directau import DirectAU as JaxDirectAU
from selfrec_tpu.ops import losses as jax_losses
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.ops import dense_dual
from selfrec_tpu_torch.ops import losses as t_losses
from tests.test_torch_xsimgcl import (BATCH, MODES, adam_step, check_step, padded_batch,
                                      set_mode, torch_step)


def _conf_dict():
    return {
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "DirectAU", "type": "graph"},
        "item.ranking.topN": [10, 20], "embedding.size": 16, "max.epoch": 1,
        "batch.size": BATCH, "learning.rate": 0.01, "reg.lambda": 0.0001,
        "output": "unused", "seed": 11, "DirectAU": {"gamma": 2, "n_layers": 3},
    }


def _inputs(n_valid, seed=0, n=48, d=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n, d)).astype(np.float32)
    x[3] = 0.0  # an exactly-zero row: finite grads through l2_normalize
    x[n - 1] = x[0]  # a pad row duplicating row 0, as the epoch's padding does
    mask = (np.arange(n) < n_valid).astype(np.float32)
    return x, y, mask


LOSSES = {
    "alignment": lambda L, x, y, m: L.alignment_loss_masked(x, y, m),
    "alignment_unmasked": lambda L, x, y, m: L.alignment_loss_masked(x, y),
    "uniformity": lambda L, x, y, m: L.uniformity_loss(x),
    "uniformity_masked": lambda L, x, y, m: L.uniformity_loss_masked(x, m),
    "uniformity_masked_t3": lambda L, x, y, m: L.uniformity_loss_masked(y, m, t=3),
}


@pytest.mark.parametrize("n_valid", [48, 24, 2, 1, 0])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_and_grads_match_jax(name, n_valid):
    x, y, mask = _inputs(n_valid)
    f = LOSSES[name]
    jv, jg = jax.value_and_grad(
        lambda a, b: f(jax_losses, a, b, jnp.asarray(mask)), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    tv = f(t_losses, tx, ty, torch.from_numpy(mask))
    tv.backward()
    assert tv.shape == ()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6, atol=1e-7)
    for t, j in ((tx, jg[0]), (ty, jg[1])):
        g = np.zeros_like(x) if t.grad is None else t.grad.numpy()
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, np.asarray(j), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("n_valid", [48, 31, 2])
def test_uniformity_masked_is_pdist_over_the_valid_rows(n_valid):
    """The reference's exact-size ``torch.pdist`` (DirectAU.py:42-45) over
    the valid rows alone equals the masked full-matrix loss over the
    padded batch."""
    x, _, mask = _inputs(n_valid, seed=1)
    valid = torch.from_numpy(x[:n_valid])
    xn = torch.nn.functional.normalize(valid, dim=-1)
    want = torch.pdist(xn, p=2).pow(2).mul(-2).exp().mean().log()
    got = t_losses.uniformity_loss_masked(torch.from_numpy(x), torch.from_numpy(mask))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 1])
def test_uniformity_without_pairs_is_zero_with_zero_grad(n_valid):
    """Fewer than two valid rows: no pair. The JAX package returns 0 with a
    zero gradient (PARITY.md); the port too, where a plain logsumexp over
    nothing would give -inf and a NaN gradient."""
    x, _, mask = _inputs(n_valid)
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = t_losses.uniformity_loss_masked(tx, torch.from_numpy(mask))
    loss.backward()
    assert float(loss.detach()) == 0.0
    assert torch.equal(tx.grad, torch.zeros_like(tx))


def _models(monkeypatch, dataset, mode):
    set_mode(monkeypatch, mode)
    train, test = dataset
    jm = JaxDirectAU(JaxConf(_conf_dict()), train, test)
    jm.build()
    tm = get_model_class("DirectAU")(ModelConf(_conf_dict()), train, test, device="cpu")
    tm.build()
    tm.set_params(convert.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()},
                                          device="cpu"))
    assert type(jm.adj).__name__ == type(tm.adj).__name__
    return jm, tm


@pytest.mark.parametrize("mode", MODES)
def test_one_step_matches_jax(monkeypatch, tiny_graph_dataset, mode):
    jm, tm = _models(monkeypatch, tiny_graph_dataset, mode)
    batch = padded_batch(tm.data, seed=4, n_valid=40)
    launches = dense_dual.dual_matmul.launches
    jax_out = adam_step(jm, batch, jax.random.PRNGKey(0))
    torch_out = torch_step(tm, batch)
    assert dense_dual.dual_matmul.launches == launches  # CPU: plain version
    check_step(mode, jax_out, torch_out)


@pytest.mark.parametrize("n_valid", [BATCH // 2, 1])
def test_backward_is_finite_on_padded_batches(monkeypatch, tiny_graph_dataset, n_valid):
    """A half-padded batch and a batch of one valid row (no uniformity
    pair): finite loss and grads."""
    _, tm = _models(monkeypatch, tiny_graph_dataset, "ell")
    batch = {k: torch.from_numpy(v) for k, v in
             padded_batch(tm.data, seed=2, n_valid=n_valid).items()}
    loss = tm.batch_loss(tm.params, batch)
    loss.backward()
    assert torch.isfinite(loss)
    for v in tm.params.values():
        assert bool(torch.isfinite(v.grad).all())


def test_negatives_are_drawn_and_ignored(monkeypatch, tiny_graph_dataset):
    """As in the JAX package, the trainer draws negatives (they advance the
    step generator) and the loss does not read them."""
    _, tm = _models(monkeypatch, tiny_graph_dataset, "ell")
    batch = {k: torch.from_numpy(v) for k, v in padded_batch(tm.data).items()}
    other = dict(batch, j=torch.zeros_like(batch["j"]))
    assert torch.equal(tm.batch_loss(tm.params, batch), tm.batch_loss(tm.params, other))
    state = tm.generator.get_state()
    tm.train_step({k: batch[k] for k in ("u", "i", "mask")})
    assert not torch.equal(state, tm.generator.get_state())
