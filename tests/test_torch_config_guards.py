"""Config keys and eval knobs that the JAX package acts on are never
silently ignored by the port: each is honoured as there (the checkpoint
and profiler keys, the mesh, the eval mask and top-k knobs), or raises
(a mesh above the world, as the JAX package's ``build_mesh`` does;
``distributed`` without the launcher's environment; an unknown
``SELFREC_TPU_EVAL_TOPK``, naming ROADMAP.md). The eval knobs' cases rank
as the JAX package does on the same embeddings: ids and metric strings
equal. The mesh's runs over several processes are in
tests/test_torch_parallel.py."""

import os

import jax
import numpy as np
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.data.interaction import Interaction as JaxInteraction
from selfrec_tpu.ops import ranking as jax_ranking
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.data.interaction import Interaction
from selfrec_tpu_torch.models.graph.simgcl import SimGCL
from selfrec_tpu_torch.ops import ranking
from selfrec_tpu_torch.utils import metrics

CONF = {"training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "SimGCL", "type": "graph"}, "item.ranking.topN": [10],
        "embedding.size": 16, "max.epoch": 1, "batch.size": 64,
        "learning.rate": 0.01, "reg.lambda": 0.0001, "output": "unused",
        "SimGCL": {"n_layer": 2, "lambda": 0.5, "eps": 0.1}}


def _model(dataset, **extra):
    train, test = dataset
    return SimGCL(ModelConf(dict(CONF, **extra)), train, test, device="cpu")


@pytest.mark.parametrize("key,epochs,written", [
    ("checkpoint.dir", 5, ["step_5"]),  # the default interval, 5 epochs
    ("checkpoint.interval", 2, ["step_1", "step_2"]),
    ("profile.dir", 2, ["SimGCL_epoch2"])])
def test_checkpoint_and_profiler_keys_are_honoured(tiny_graph_dataset, tmp_path, key,
                                                   epochs, written):
    """Each key acts as in the JAX package (base.py:624-690): checkpoints
    under ``checkpoint.dir`` every ``checkpoint.interval`` epochs (default
    5), a trace of the second epoch in ``profile.dir``."""
    extra = {"max.epoch": epochs, "output": str(tmp_path / "out")}
    if key.startswith("checkpoint"):
        extra["checkpoint.dir"] = str(tmp_path / "written")
    if key == "checkpoint.interval":
        extra[key] = 1
    if key == "profile.dir":
        extra[key] = str(tmp_path / "written")
    model = _model(tiny_graph_dataset, **extra)
    model.build()
    model.train()
    found = sorted(name.split("_")[0] + "_" + name.split("_")[1]
                   for name in os.listdir(tmp_path / "written"))
    assert found == written


@pytest.mark.parametrize("mesh", [{"data": 2, "model": 1}, {"data": 1, "model": 2},
                                  {"data": 2, "model": 2}, {"data": 8, "model": 1}])
def test_mesh_above_one_device_raises(tiny_graph_dataset, mesh):
    """One process is a world of one device: a larger mesh raises the JAX
    package's ValueError (mesh.py:51-52), word for word."""
    from selfrec_tpu.parallel.mesh import build_mesh as jax_build_mesh

    with pytest.raises(ValueError) as theirs:
        jax_build_mesh(mesh["data"], mesh["model"], devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="needs more than 1 devices") as mine:
        _model(tiny_graph_dataset, mesh=mesh)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("mesh", [{"data": 1, "model": 1}, {"data": 1}, {}, None])
def test_one_by_one_mesh_is_the_single_device_path(tiny_graph_dataset, mesh):
    model = _model(tiny_graph_dataset, mesh=mesh)
    assert model.device == torch.device("cpu")


def test_distributed_on_raises_and_off_is_allowed(tiny_graph_dataset, monkeypatch):
    """``distributed: true`` without torchrun's variables raises and names
    them; off, the model is built as usual."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="distributed.*missing MASTER_ADDR, MASTER_PORT, "
                                           "WORLD_SIZE, RANK, LOCAL_RANK"):
        _model(tiny_graph_dataset, distributed=True)
    _model(tiny_graph_dataset, distributed=False)


@pytest.mark.parametrize("device,local_world,cards,shares", [
    ("cuda", "2", 1, True), ("cuda", "2", 2, False), ("cuda", None, 1, False),
    ("cpu", "4", 1, False)])
def test_more_local_ranks_than_cards_share_them(monkeypatch, device, local_world, cards,
                                                shares):
    """A node with more ranks (torchrun's ``LOCAL_WORLD_SIZE``) than cards
    shares them, and so takes gloo: NCCL refuses two ranks on one card."""
    from selfrec_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    assert distributed.shares_cards(torch.device(device)) is shares


# -- eval knobs ----------------------------------------------------------------

@pytest.fixture()
def eval_case(tiny_graph_dataset):
    train, test = tiny_graph_dataset
    data = Interaction(ModelConf(dict(CONF)), train, test)
    rng = np.random.default_rng(11)
    ue = torch.from_numpy(rng.normal(size=(data.user_num, 16)).astype(np.float32))
    ie = torch.from_numpy(rng.normal(size=(data.item_num, 16)).astype(np.float32))
    return data, ue, ie


def _measure(data, ue, ie):
    top = ranking.topk_ids_from_embeddings(data, ue, ie, 10)
    offsets, items = data.test_gt_csr()
    return metrics.ranking_evaluation_ids(offsets, items, top, [10], data.item_num,
                                          sorted_test_keys=data.test_gt_sorted_keys())


def _jax_ids(tiny_graph_dataset, ue, ie):
    """The JAX package's top-10 ids on the same embeddings, under the knobs
    set now."""
    train, test = tiny_graph_dataset
    jd = JaxInteraction(JaxConf(dict(CONF)), train, test)
    return jax_ranking.topk_ids_from_embeddings(jd, ue.numpy(), ie.numpy(), 10)


@pytest.mark.parametrize("value", ["approx", "approx:0.9", "something"])
def test_eval_topk_other_than_exact_raises(eval_case, tiny_graph_dataset, monkeypatch, value):
    """``approx`` and ``approx:r`` rank exactly, as ``lax.approx_max_k``
    does off the TPU (the JAX package's ids on the CPU); any other value
    raises naming ROADMAP.md."""
    exact = _measure(*eval_case)
    monkeypatch.setenv("SELFREC_TPU_EVAL_TOPK", value)
    if value == "something":
        with pytest.raises(NotImplementedError, match="approx.*ROADMAP.md"):
            _measure(*eval_case)
        return
    assert ranking.eval_topk_recall() == (0.9 if value.endswith("0.9") else 0.95)
    assert _measure(*eval_case) == exact
    data, ue, ie = eval_case
    np.testing.assert_array_equal(ranking.topk_ids_from_embeddings(data, ue, ie, 10),
                                  _jax_ids(tiny_graph_dataset, ue, ie))


def test_eval_topk_exact_ranks(eval_case, monkeypatch):
    monkeypatch.setenv("SELFREC_TPU_EVAL_TOPK", "exact")
    exact = _measure(*eval_case)
    monkeypatch.delenv("SELFREC_TPU_EVAL_TOPK")
    assert _measure(*eval_case) == exact


def test_eval_mask_scatter_raises(eval_case, tiny_graph_dataset, monkeypatch):
    """``SELFREC_TPU_EVAL_MASK=scatter`` ranks through the scatter-mask
    plan, as the JAX package does (ranking.py:53-55), with no (U, I) mask
    built, and equals the resident mask's ranking."""
    data, ue, ie = eval_case
    dense = _measure(data, ue, ie)
    data._rated_dense_cache = None
    monkeypatch.setenv("SELFREC_TPU_EVAL_MASK", "scatter")
    assert _measure(data, ue, ie) == dense
    assert data._rated_dense_cache is None
    np.testing.assert_array_equal(ranking.topk_ids_from_embeddings(data, ue, ie, 10),
                                  _jax_ids(tiny_graph_dataset, ue, ie))


def test_eval_mask_auto_over_budget_raises(eval_case, tiny_graph_dataset, monkeypatch):
    """``auto`` with the mask over ``SELFREC_TPU_DENSE_BUDGET_GB`` builds no
    mask and ranks through the scatter-mask plan (ranking.py:62-65), as the
    JAX package does."""
    data, ue, ie = eval_case
    dense = _measure(data, ue, ie)
    data._rated_dense_cache = None
    monkeypatch.setenv("SELFREC_TPU_EVAL_MASK", "auto")
    monkeypatch.setenv("SELFREC_TPU_DENSE_BUDGET_GB", "0")
    assert ranking.get_rated_dense(data, "cpu") is None
    assert _measure(data, ue, ie) == dense
    assert data._rated_dense_cache is None
    np.testing.assert_array_equal(ranking.topk_ids_from_embeddings(data, ue, ie, 10),
                                  _jax_ids(tiny_graph_dataset, ue, ie))


def test_eval_mask_dense_builds_past_the_budget(eval_case, monkeypatch):
    """As the JAX package (ranking.py:53-64): ``dense`` builds the mask with
    the budget at 0, and ranks as ``auto`` does within the budget."""
    data, ue, ie = eval_case
    auto = _measure(data, ue, ie)
    data._rated_dense_cache = None
    monkeypatch.setenv("SELFREC_TPU_EVAL_MASK", "dense")
    monkeypatch.setenv("SELFREC_TPU_DENSE_BUDGET_GB", "0")
    assert _measure(data, ue, ie) == auto
    assert data._rated_dense_cache.shape == (data.user_num, data.item_num)
