"""UserKNN and ItemKNN of the port (ops/knn.py, models/graph/{userknn,
itemknn}.py) against the JAX package on the same graph.

KNN has no stochasticity, so the port is held to the JAX package EXACTLY:
the neighbour sims (f32, bit for bit) and ids, the scores of each block,
and the rec lists, ids and scores. The graph is built to tie: binary
ratings, and users (items) that copy another's ratings, so shrunk-cosine
sims repeat, whole rows of sims tie at the top-k boundary, and the scores
``s / (s + 1e-8)`` saturate at 1.0; both packages break every tie by the
lowest index. XLA's CPU backend contracts the sims' denominator into one
fused multiply-add; the port computes it rounded once as well
(``knn.shrunk_cosine``), which is what makes the sims equal bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models import get_model_class as jax_model_class
from selfrec_tpu.ops import knn as jax_knn
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.ops import knn

MODELS = ["UserKNN", "ItemKNN"]


@functools.lru_cache(maxsize=None)
def tie_graph(n_users=90, n_items=70, seed=3):
    """(train, test) triples: 60 users with 5-15 random items each, and 30
    more that copy one of them (one of their ratings moved to the test
    set), so many users and items share their rated sets."""
    rng = np.random.default_rng(seed)
    rated = [rng.choice(n_items, int(rng.integers(5, 16)), replace=False)
             for _ in range(60)]
    rated += [rated[int(rng.integers(60))] for _ in range(n_users - 60)]
    train, test = [], []
    for u, items in enumerate(rated):
        for i in items[:-1]:
            train.append((f"u{u}", f"i{i}", 1.0))
        test.append((f"u{u}", f"i{items[-1]}", 1.0))
    return train, test


def conf(name, top_k=10, shrinkage=5):
    return {"training.set": "<memory>", "test.set": "<memory>",
            "model": {"name": name, "type": "graph"}, "item.ranking.topN": [10, 20],
            "embedding.size": 16, "max.epoch": 1, "batch.size": 64,
            "learning.rate": 0.001, "reg.lambda": 0.0001, name: {},
            "output": "unused", "topK": top_k, "shrinkage": shrinkage, "seed": 0}


def pair(name, dataset=None, **kw):
    train, test = dataset or tie_graph()
    jm = jax_model_class(name)(JaxConf(conf(name, **kw)), train, test)
    tm = get_model_class(name)(ModelConf(conf(name, **kw)), train, test, device="cpu")
    return jm, tm


def neighbours(model):
    """(sims, ids) of either package's model after train()."""
    if hasattr(model, "neighbor_sims"):
        return np.asarray(model.neighbor_sims), np.asarray(model.neighbor_ids)
    adj = model._sim_adj
    return tuple(np.asarray(a) for a in (adj.src, adj.dst, adj.w))


@pytest.mark.parametrize("side", ["users", "items"])
@pytest.mark.parametrize("block", [16, 1024])
def test_topk_shrunk_cosine_equals_jax_bit_for_bit(side, block):
    """Several blocks (16) and one padded block (1024); the last block is
    ragged either way. The sims tie at the k boundary in many rows."""
    _, tm = pair("UserKNN")
    d = tm.data
    dst, src, n_dst, n_src = ((d.edge_users, d.edge_items, d.user_num, d.item_num)
                              if side == "users" else
                              (d.edge_items, d.edge_users, d.item_num, d.user_num))
    deg = np.bincount(dst, minlength=n_dst).astype(np.float32)
    k = 10
    js, ji = jax_knn.topk_shrunk_cosine(dst, src, n_dst, n_src, jnp.asarray(deg), 5, k,
                                        block=block)
    ts, ti = knn.topk_shrunk_cosine(dst, src, n_dst, n_src, torch.from_numpy(deg), 5, k,
                                    block=block)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the graph ties: many rows hold equal sims among their top k
    full = ts.numpy()
    assert ((full[:, :-1] == full[:, 1:]) & (full[:, 1:] > 0)).any(1).mean() > 0.2


@pytest.mark.parametrize("name", MODELS)
def test_blocked_fallback_equals_the_dense_build(monkeypatch, name):
    """With ``SELFREC_TPU_DENSE_BUDGET_GB`` too small for the dense R, both
    packages take their blocked edge-list builds (BLOCK 512, so one padded
    block here); the port's equals JAX's and its own dense build, sims bit
    for bit."""
    jm, tm = pair(name)
    tm.train()
    dense = neighbours(tm)
    monkeypatch.setenv("SELFREC_TPU_DENSE_BUDGET_GB", "1e-9")
    assert not knn.dense_available(tm.data.user_num, tm.data.item_num)
    jm.train()
    blocked_tm = get_model_class(name)(ModelConf(conf(name)), *tie_graph(), device="cpu")
    blocked_tm.train()
    blocked = neighbours(blocked_tm)
    for a, b, c in zip(blocked, dense, neighbours(jm)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("top_k", [10, 500])
def test_score_blocks_and_rec_lists_equal_jax(name, top_k):
    """Each eval block's scores and the rec list (``test()``, through the
    scatter-mask plan) equal JAX's exactly; topK 500 is above the graph's
    entity count, so k_eff is the count less one."""
    jm, tm = pair(name, top_k=top_k)
    assert tm.k_eff == jm.k_eff
    if top_k == 500:
        assert tm.k_eff < top_k
    jm.train()
    tm.train()
    for a, b in zip(neighbours(tm), neighbours(jm)):
        np.testing.assert_array_equal(a, b)
    from selfrec_tpu.ops import ranking as jax_ranking
    from selfrec_tpu_torch.ops import ranking

    jplan = jax_ranking.get_eval_plan(jm.data, 512)
    plan = ranking.get_eval_plan(tm.data, 512, "cpu")
    for (tu, *_), (ju, *_) in zip(plan.blocks, jplan.blocks):
        ts = tm._score_block(tu)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(jm._score_block(ju)))
        assert (ts == 1.0).float().mean() > 0.05  # saturated scores tie
    assert tm.test() == jm.test()


@pytest.mark.parametrize("name", MODELS)
def test_execute_runs_and_writes_the_reference_files(tmp_path, name):
    """Registered, and ``execute()`` runs build, train, test and evaluate
    through the session on the CPU, writing the rec list and the metrics."""
    from selfrec_tpu_torch import SelfRecTorch
    from selfrec_tpu_torch.utils import metrics

    train, test = tie_graph()
    c = dict(conf(name), output=str(tmp_path))
    rec_list = SelfRecTorch(ModelConf(c), device="cpu", training_data=train,
                            test_data=test).execute()
    assert len(rec_list) == len({u for u, _, _ in test})
    assert all(len(v) == 20 for v in rec_list.values())
    written = sorted(p.name for p in tmp_path.iterdir())
    assert len(written) == 2 and all(w.startswith(f"{name}@") for w in written)
    assert written[0].endswith("-performance.txt") and written[1].endswith("-top-20items.txt")
    perf = metrics.parse_measure(metrics.ranking_evaluation(
        {u: {i: 1.0} for u, i, _ in test}, rec_list, [20]))
    assert 0.0 <= perf["Recall"] <= 1.0
