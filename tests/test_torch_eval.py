"""Full-rank eval of the port (ops/ranking.py, utils/metrics.py) against the
JAX package on the same embeddings.

Embeddings are continuous random values from numpy, so no two scores tie
and both top-k orders are defined (lax.top_k and torch.topk may order ties
differently). Item ids and metric strings must be EQUAL; scores are the
same f32 dot products summed in another order, rtol 1e-6."""

import numpy as np
import pytest
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.data.interaction import Interaction as JaxInteraction
from selfrec_tpu.ops import ranking as jax_ranking
from selfrec_tpu.utils import metrics as jax_metrics
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.data.interaction import Interaction
from selfrec_tpu_torch.ops import ranking
from selfrec_tpu_torch.utils import metrics

CONF = {"training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "SimGCL", "type": "graph"}, "item.ranking.topN": [10],
        "embedding.size": 16, "max.epoch": 1, "batch.size": 64,
        "learning.rate": 0.01, "reg.lambda": 0.0001, "output": "unused"}


@pytest.fixture(scope="module")
def both_data(tiny_graph_dataset):
    train, test = tiny_graph_dataset
    return (JaxInteraction(JaxConf(dict(CONF)), train, test),
            Interaction(ModelConf(dict(CONF)), train, test))


def _embeddings(data, seed=0, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(data.user_num, d)).astype(np.float32),
            rng.normal(size=(data.item_num, d)).astype(np.float32))


def test_interaction_copy_builds_the_same_arrays(both_data):
    jd, td = both_data
    for name in ("edge_users", "edge_items", "rated_offsets", "rated_items",
                 "test_user_ids"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    assert (td.norm_adj != jd.norm_adj).nnz == 0
    for a, b in zip(td.test_gt_csr(), jd.test_gt_csr()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("block_size", [7, 1024])
@pytest.mark.parametrize("k", [10, 20])
def test_topk_ids_equal_jax(both_data, block_size, k):
    jd, td = both_data
    ue, ie = _embeddings(td, seed=k + block_size)
    ref = jax_ranking.topk_ids_from_embeddings(jd, ue, ie, k, block_size=block_size)
    got = ranking.topk_ids_from_embeddings(td, torch.from_numpy(ue),
                                           torch.from_numpy(ie), k,
                                           block_size=block_size)
    np.testing.assert_array_equal(got, ref)
    # rated items are never recommended
    for row, uid in zip(got, td.test_user_ids):
        rated = td.rated_items[td.rated_offsets[uid]:td.rated_offsets[uid + 1]]
        assert not set(row.tolist()) & set(rated.tolist())


def test_rec_list_equal_jax(both_data):
    jd, td = both_data
    ue, ie = _embeddings(td, seed=3)
    ref = jax_ranking.rec_list_from_embeddings(jd, ue, ie, 10, block_size=16)
    got = ranking.rec_list_from_embeddings(td, torch.from_numpy(ue),
                                           torch.from_numpy(ie), 10, block_size=16)
    assert list(got) == list(ref)
    for user in ref:
        assert [n for n, _ in got[user]] == [n for n, _ in ref[user]]
        np.testing.assert_allclose([s for _, s in got[user]],
                                   [s for _, s in ref[user]], rtol=1e-6)


def test_metric_strings_equal_jax_and_the_string_path(both_data):
    jd, td = both_data
    ue, ie = _embeddings(td, seed=5)
    top = ranking.topk_ids_from_embeddings(td, torch.from_numpy(ue),
                                           torch.from_numpy(ie), 20)
    offsets, items = td.test_gt_csr()
    got = metrics.ranking_evaluation_ids(offsets, items, top, [5, 10, 20],
                                         td.item_num,
                                         sorted_test_keys=td.test_gt_sorted_keys())
    ref = jax_metrics.ranking_evaluation_ids(offsets, items, top, [5, 10, 20],
                                             td.item_num)
    assert got == ref
    rec = ranking.rec_list_from_embeddings(td, torch.from_numpy(ue),
                                           torch.from_numpy(ie), 20)
    assert metrics.ranking_evaluation(td.test_set, rec, [5, 10, 20]) == got
    assert jax_metrics.ranking_evaluation(jd.test_set, rec, [5, 10, 20]) == got
