"""Weights cross between the packages unchanged (selfrec_tpu_torch.convert)."""

import jax
import numpy as np
import pytest
import torch

from selfrec_tpu.ops.init import xavier_uniform as jax_xavier
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.ops.init import xavier_uniform


def _jax_params():
    ku, ki = jax.random.split(jax.random.PRNGKey(0))
    return {"user_emb": jax_xavier(ku, (40, 16)), "item_emb": jax_xavier(ki, (60, 16)),
            "step": jax.numpy.arange(3, dtype=jax.numpy.int32)}


def test_params_round_trip_exactly():
    jp = {k: np.asarray(v) for k, v in _jax_params().items()}
    tp = convert.params_from_jax(jp, device="cpu")
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].numpy().dtype == jp[k].dtype
        np.testing.assert_array_equal(tp[k].numpy(), jp[k])
    back = convert.params_to_jax(tp)
    for k in jp:
        assert back[k].dtype == jp[k].dtype
        np.testing.assert_array_equal(back[k], jp[k])
    # the tensors own their memory: changing one leaves the source alone
    tp["user_emb"].add_(1.0)
    assert not np.array_equal(tp["user_emb"].numpy(), jp["user_emb"])


def test_round_trip_through_jax_arrays():
    tp = {"w": torch.linspace(-1, 1, 12).reshape(3, 4)}
    jp = {k: jax.numpy.asarray(v) for k, v in convert.params_to_jax(tp).items()}
    again = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    assert torch.equal(again["w"], tp["w"])


def test_xavier_uniform_has_the_jax_bound_and_shape():
    """Same distribution as the JAX initialiser (different draws)."""
    t = xavier_uniform(torch.Generator().manual_seed(0), (400, 64), device="cpu")
    j = np.asarray(jax_xavier(jax.random.PRNGKey(0), (400, 64)))
    bound = np.sqrt(6.0 / (400 + 64))
    assert t.shape == j.shape and t.dtype == torch.float32
    assert float(t.abs().max()) <= bound and np.abs(j).max() <= bound
    assert abs(float(t.std()) - float(j.std())) < 0.02 * bound


def test_xavier_uniform_needs_an_explicit_device():
    with pytest.raises(TypeError, match="device"):
        xavier_uniform(torch.Generator().manual_seed(0), (4, 8))


@pytest.mark.parametrize("name", ["SimGCL", "LightGCN", "SGL", "MF", "XSimGCL",
                                  "DirectAU", "MixGCF", "NCL", "BUIR", "SelfCF",
                                  "SSL4Rec"])
def test_model_params_cross_unchanged(monkeypatch, tiny_graph_dataset, name):
    """A JAX model's parameters install into the port's model of the same
    name (same dotted keys, shapes and dtypes as its own init) and come back
    as the same tree."""
    from selfrec_tpu.config import ModelConf as JaxConf
    from selfrec_tpu.models import get_model_class as jax_model_class
    from selfrec_tpu_torch.config import ModelConf
    from selfrec_tpu_torch.models import get_model_class

    monkeypatch.setenv("SELFREC_TPU_DENSE", "0")
    conf = {"training.set": "<memory>", "test.set": "<memory>",
            "model": {"name": name, "type": "graph"}, "item.ranking.topN": [10],
            "embedding.size": 8, "max.epoch": 1, "batch.size": 32,
            "learning.rate": 0.01, "reg.lambda": 0.0001, "output": "unused"}
    train, test = tiny_graph_dataset
    jm = jax_model_class(name)(JaxConf(dict(conf)), train, test)
    tm = get_model_class(name)(ModelConf(dict(conf)), train, test, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(1)))
    jp = convert.flatten_params(tree)
    own = tm.init_params(torch.Generator().manual_seed(1))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in own.items()} == {
        k: (v.shape, f"torch.{v.dtype}") for k, v in jp.items()}
    tm.set_params(convert.params_from_jax(tree, device="cpu"))
    back = convert.params_to_jax(tm.params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for k, v in convert.flatten_params(back).items():
        np.testing.assert_array_equal(v, jp[k])


def test_params_from_jax_defaults_to_the_card(monkeypatch):
    """Like every entry point of the port, the converter puts weights on the
    card unless asked for the CPU, and raises where there is no card."""
    jp = {"w": np.ones((2, 3), np.float32)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax(jp)
    assert convert.params_from_jax(jp, device="cpu")["w"].device.type == "cpu"


def test_nested_params_flatten_to_dotted_keys_and_back():
    """Layers as nested dicts and lists (BUIR's predictor, SSL4Rec's towers)
    flatten to dotted keys in the tree's order, and unflatten to the same
    tree; a flat dict is its own flattening."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    tree = {"user_emb": w, "predictor": {"w": w.T, "b": w[0]},
            "user_tower": [{"w": w, "b": w[1]}, {"w": w.T, "b": w[0, :2]}]}
    flat = convert.flatten_params(tree)
    assert list(flat) == ["user_emb", "predictor.w", "predictor.b", "user_tower.0.w",
                          "user_tower.0.b", "user_tower.1.w", "user_tower.1.b"]
    tp = convert.params_from_jax(tree, device="cpu")
    assert list(tp) == list(flat)
    back = convert.params_to_jax(tp)
    assert isinstance(back["user_tower"], list) and len(back["user_tower"]) == 2
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert convert.flatten_params({"a": w, "b": w}) == {"a": w, "b": w}
