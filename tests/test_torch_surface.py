"""The JAX package's public surface that no model calls, in the port: the
losses ``triplet_loss``, ``info_nce_recbole``, ``kl_divergence`` and
``ssm_loss`` (torch), and the numpy copies ``utils/similarity.py`` and
``data/augmentor.py``, each against the JAX package on the same inputs.

Tolerances: losses and their grads rtol 1e-5 / atol 1e-6 (f32 sums in
another order); the numpy copies equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from selfrec_tpu.data import augmentor as jaug
from selfrec_tpu.ops import losses as jl
from selfrec_tpu.utils import similarity as jsim
from selfrec_tpu_torch.data import augmentor as taug
from selfrec_tpu_torch.ops import losses as tl
from selfrec_tpu_torch.utils import similarity as tsim


def _views(seed, n=16, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, d)).astype(np.float32) for _ in range(3)]


def _mask(n=16, n_valid=11):
    return (np.arange(n) < n_valid).astype(np.float32)


LOSSES = {
    "triplet": (lambda f, a, b, c, m: f.triplet_loss(a, b, c)),
    "triplet_margin_masked": (
        lambda f, a, b, c, m: f.triplet_loss(a, b, c, margin=2.0, mask=m)),
    "info_nce_recbole_dot": (lambda f, a, b, c, m: f.info_nce_recbole(a, b, 0.5, 16)),
    "info_nce_recbole_cos": (
        lambda f, a, b, c, m: f.info_nce_recbole(a, b, 0.2, 16, sim="cos")),
    "kl_divergence": (lambda f, a, b, c, m: f.kl_divergence(a, b)),
    "ssm": (lambda f, a, b, c, m: f.ssm_loss(a, b, c)),
    "ssm_masked": (lambda f, a, b, c, m: f.ssm_loss(a, b, c, mask=m)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_grads_match_jax(name):
    fn = LOSSES[name]
    a, b, c = _views(len(name))
    m = _mask()
    want, jgrads = jax.value_and_grad(
        lambda x, y, z: fn(jl, x, y, z, jnp.asarray(m)), argnums=(0, 1, 2))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (a, b, c)]
    got = fn(tl, *ts, torch.from_numpy(m))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for tv, jg in zip(ts, jgrads):
        grad = np.zeros_like(a) if tv.grad is None else tv.grad.numpy()
        np.testing.assert_allclose(grad, np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_ssm_loss_closed_form():
    """tests/test_ops.py:297's hand-checked case, in the port."""
    u = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    p = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    n = torch.tensor([[0.0, 1.0], [1.0, 0.0]])
    pos = np.exp(5.0)
    ttl0 = np.exp(5.0) + np.exp(0.0) + np.exp(5.0)
    np.testing.assert_allclose(float(tl.ssm_loss(u, p, n)), -np.log(pos / ttl0), rtol=1e-5)


def _dense_pairs(seed):
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal(20) * (rng.random(20) < 0.7)
    x2 = rng.standard_normal(20) * (rng.random(20) < 0.7)
    return x1, x2


def _sparse(x):
    return {i: float(v) for i, v in enumerate(x) if v != 0}


@pytest.mark.parametrize("seed", [0, 1])
def test_similarity_copy_equals_jax_package(seed):
    x1, x2 = _dense_pairs(seed)
    for fn in ("l1", "l2"):
        assert getattr(tsim, fn)(x1) == getattr(jsim, fn)(x1)
    for fn in ("cosine", "pearson", "euclidean"):
        assert getattr(tsim, fn)(x1, x2) == getattr(jsim, fn)(x1, x2), fn
    for fn in ("cosine_sp", "pearson_sp", "euclidean_sp"):
        assert getattr(tsim, fn)(_sparse(x1), _sparse(x2)) == \
            getattr(jsim, fn)(_sparse(x1), _sparse(x2)), fn
    for kind in ("pcc", "euclidean", "cos"):
        assert tsim.similarity(_sparse(x1), _sparse(x2), kind) == \
            jsim.similarity(_sparse(x1), _sparse(x2), kind)
    for a, b in zip(tsim.common(x1, x2), jsim.common(x1, x2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsim.normalize(x1, 3.0, -2.0), jsim.normalize(x1, 3.0, -2.0))
    np.testing.assert_array_equal(tsim.denormalize(x1, 3.0, -2.0),
                                  jsim.denormalize(x1, 3.0, -2.0))
    assert tsim.sigmoid(0.3) == jsim.sigmoid(0.3)
    scores = np.random.default_rng(seed).permutation(50).astype(np.float64)
    assert tsim.find_k_largest(7, scores) == jsim.find_k_largest(7, scores)
    with pytest.raises(ArithmeticError):
        tsim.normalize(x1, 1.0, 2.0)


def test_zero_division_conventions_match():
    z = np.zeros(5)
    assert tsim.cosine(z, z) == jsim.cosine(z, z) == 0.0
    assert tsim.pearson_sp({}, {1: 1.0}) == jsim.pearson_sp({}, {1: 1.0}) == 0.0
    assert tsim.euclidean(z, z) == jsim.euclidean(z, z) == 0.0


@pytest.mark.parametrize("method", ["node_dropout", "edge_dropout"])
def test_graph_augmentor_copy_equals_jax_package(method):
    adj = sp.random(30, 40, density=0.2, format="csr", random_state=4, dtype=np.float32)
    got = getattr(taug.GraphAugmentor, method)(adj, 0.3, np.random.default_rng(8))
    want = getattr(jaug.GraphAugmentor, method)(adj, 0.3, np.random.default_rng(8))
    assert got.shape == want.shape and (got != want).nnz == 0
    assert 0 < got.nnz < adj.nnz


def test_sequence_augmentor_copy_equals_jax_package():
    rng = np.random.default_rng(5)
    seq = rng.integers(1, 30, (12, 10))
    seq_len = rng.integers(1, 11, 12)
    for i, n in enumerate(seq_len):
        seq[i, n:] = 0
    crop_t = taug.SequenceAugmentor.item_crop(seq, seq_len, 0.5, np.random.default_rng(1))
    crop_j = jaug.SequenceAugmentor.item_crop(seq, seq_len, 0.5, np.random.default_rng(1))
    for a, b in zip(crop_t, crop_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        taug.SequenceAugmentor.item_reorder(seq, seq_len, 0.5, np.random.default_rng(2)),
        jaug.SequenceAugmentor.item_reorder(seq, seq_len, 0.5, np.random.default_rng(2)))
    np.testing.assert_array_equal(
        taug.SequenceAugmentor.item_mask(seq, seq_len, 0.5, 31, np.random.default_rng(3)),
        jaug.SequenceAugmentor.item_mask(seq, seq_len, 0.5, 31, np.random.default_rng(3)))
