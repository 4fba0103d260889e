"""The port's transformer encoder (selfrec_tpu_torch/ops/transformer.py)
against selfrec_tpu/ops/transformer.py, on the same weights (JAX's
``init_encoder_params`` carried by ``params_from_jax``) and inputs.

Tolerance: rtol 1e-5 / atol 1e-5 in f32 (XLA and torch sum the products
in other orders), with dropout off and once with JAX's keep masks fed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.ops import transformer as jtr
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.ops import transformer as ttr

from _seq_data import keep_masks, t

B, L, D, V = 6, 10, 16, 30


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([10, 1, 4, 7, 9, 2])
    seq = np.zeros((B, L), np.int32)
    pos = np.zeros((B, L), np.int32)
    for r, n in enumerate(lens):
        seq[r, :n] = rng.integers(1, V, n)
        pos[r, :n] = np.arange(1, n + 1)
    return seq, pos


def _params(n_blocks=2, n_pos=L + 1):
    jp = jtr.init_encoder_params(jax.random.PRNGKey(1), V, n_pos, D, n_blocks)
    # nonzero biases and LayerNorm affines, so their paths are exercised
    rng = np.random.default_rng(2)
    jp = jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32), jp)
    return jp, convert.params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("causal,activation,n_heads", [(True, "relu", 1), (True, "relu", 2),
                                                        (False, "gelu", 1), (False, "gelu", 4)])
def test_encode_matches_jax_without_dropout(causal, activation, n_heads):
    jp, tp = _params()
    seq, pos = _inputs()
    want = jtr.encode(jp, jnp.asarray(seq), jnp.asarray(pos), n_heads, 0.3, causal,
                      activation, key=None)
    got = ttr.encode(tp, t(seq).long(), t(pos).long(), n_heads, 0.3, causal, activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # pad positions are zeroed before the final LayerNorm: its bias alone
    np.testing.assert_allclose(got[1, 1:].numpy(),
                               np.broadcast_to(tp["last_ln.bias"].numpy(), (L - 1, D)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,activation", [(True, "relu"), (False, "gelu")])
def test_encode_matches_jax_with_its_keep_masks_fed(causal, activation):
    jp, tp = _params()
    seq, pos = _inputs(1)
    key = jax.random.PRNGKey(9)
    want = jtr.encode(jp, jnp.asarray(seq), jnp.asarray(pos), 2, 0.3, causal, activation,
                      key=key)
    keep = keep_masks(key, 0.3, B, L, D, 2, 2)
    got = ttr.encode(tp, t(seq).long(), t(pos).long(), 2, 0.3, causal, activation, keep=keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    off = ttr.encode(tp, t(seq).long(), t(pos).long(), 2, 0.3, causal, activation)
    assert not torch.allclose(got, off, atol=1e-3)


def test_encode_grads_match_jax():
    jp, tp = _params()
    seq, pos = _inputs(2)
    w = np.random.default_rng(3).standard_normal((B, L, D)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jtr.encode(p, jnp.asarray(seq), jnp.asarray(pos), 2, 0.0, True) * w)

    jg = convert.flatten_params(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(jp)))
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    torch.sum(ttr.encode(params, t(seq).long(), t(pos).long(), 2, 0.0, True) * t(w)).backward()
    for k, v in params.items():
        np.testing.assert_allclose(v.grad.numpy(), jg[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_layer_norm_is_eps_1e8_with_the_population_variance():
    x = np.random.default_rng(4).standard_normal((5, D)).astype(np.float32) * 1e-3
    p = {"scale": np.linspace(0.5, 1.5, D, dtype=np.float32),
         "bias": np.linspace(-1, 1, D, dtype=np.float32)}
    want = np.asarray(jtr.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(x)))
    got = ttr.layer_norm(t(x), t(p["scale"]), t(p["bias"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    torch_default = torch.nn.functional.layer_norm(t(x), (D,), t(p["scale"]), t(p["bias"]))
    assert not torch.allclose(got, torch_default, atol=1e-2)


def test_gelu_is_the_tanh_form():
    x = jnp.linspace(-4, 4, 101)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(t(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(x)), rtol=1e-6, atol=1e-6)
    assert not np.allclose(torch.nn.functional.gelu(t(x)).numpy(), np.asarray(jax.nn.gelu(x)),
                           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_init_has_the_jax_tree_keys_order_and_shapes(n_blocks):
    """The port's init gives JAX's flat names in JAX's order, with the
    shapes, the zero biases and unit LayerNorm scales of init_encoder_params,
    and xavier bounds on the tables and the packed in-projection."""
    jp = jtr.init_encoder_params(jax.random.PRNGKey(0), V, L + 1, D, n_blocks)
    jflat = {k: np.asarray(v) for k, v in convert.flatten_params(jp).items()}
    tp = ttr.init_encoder_params(torch.Generator().manual_seed(0), V, L + 1, D, n_blocks,
                                 device="cpu")
    assert list(tp) == list(jflat)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jflat.items()}
    assert ttr.n_blocks_of(tp) == n_blocks
    for k, v in tp.items():
        if k.endswith((".bias", "b_in", "attn.out.b")):
            assert torch.all(v == 0) and np.all(jflat[k] == 0), k
        if k.endswith(".scale"):
            assert torch.all(v == 1), k
    assert float(tp["blocks.0.attn.w_in"].abs().max()) <= np.sqrt(6 / (4 * D))
    assert float(tp["item_emb"].abs().max()) <= np.sqrt(6 / (V + D))
    assert float(tp["item_emb"][0].abs().sum()) > 0  # the pad row is drawn too


def test_encoder_tree_round_trips_through_convert():
    """params_from_jax / params_to_jax carry the nested ``blocks`` list as
    dotted keys (blocks.0.attn.w_in, ...) and back, values unchanged."""
    jp = jtr.init_encoder_params(jax.random.PRNGKey(5), V, L + 2, D, 2)
    tp = convert.params_from_jax(jp, device="cpu")
    assert "blocks.1.attn.out.w" in tp and "blocks.0.ff2.b" in tp
    back = convert.params_to_jax(tp)
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 2
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jp))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
