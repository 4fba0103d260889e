"""Full-rank eval of the port (ops/ranking.py, utils/metrics.py) against the
JAX package on the same embeddings.

Embeddings are continuous random values from numpy, so no two scores tie
and both top-k orders are defined (lax.top_k and torch.topk may order ties
differently). Item ids and metric strings must be EQUAL; scores are the
same f32 dot products summed in another order, rtol 1e-6. The scatter-mask
plan's arrays are EQUAL to JAX's, and score-function ranking, which breaks
ties by the lowest index as lax.top_k does, gives JAX's rec list EXACTLY
on scores built to tie."""

import jax.numpy as jnp
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


@pytest.mark.parametrize("block_size", [7, 16, 1024])
def test_eval_plan_arrays_equal_jax(both_data, block_size):
    """Per block: padded uids, the rated rows (padded with row
    ``block_size``) and items (padded with 0), the valid count; and the
    stacked arrays. The port counts each block's real lanes."""
    jd, td = both_data
    ref = jax_ranking.EvalPlan(jd.test_user_ids, jd.rated_offsets, jd.rated_items, block_size)
    got = ranking.EvalPlan(td.test_user_ids, td.rated_offsets, td.rated_items, block_size,
                           "cpu")
    assert len(got.blocks) == len(ref.blocks)
    for (tu, tr, tc, tv), (ju, jr, jc, jv), n in zip(got.blocks, ref.blocks, got.n_rated):
        assert tv == jv
        for a, b in ((tu, ju), (tr, jr), (tc, jc)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert bool((tr[:n] < block_size).all()) and bool((tr[n:] == block_size).all())
    for name in ("uids_all", "rows_all", "cols_all"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("block_size", [7, 1024])
def test_scatter_scan_equals_jax(both_data, block_size):
    """The scatter-mask scan (ranking.py:260-287) on the same embeddings:
    ids exact, scores rtol 1e-6."""
    jd, td = both_data
    ue, ie = _embeddings(td, seed=11)
    jplan = jax_ranking.get_eval_plan(jd, block_size)
    jscs, jids = jax_ranking._topk_all_blocks(jnp.asarray(ue), jnp.asarray(ie),
                                              jplan.uids_all, jplan.rows_all,
                                              jplan.cols_all, 10)
    plan = ranking.get_eval_plan(td, block_size, "cpu")
    scs, ids = ranking._topk_all_blocks(torch.from_numpy(ue), torch.from_numpy(ie), plan, 10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(scs.numpy(), np.asarray(jscs), rtol=1e-6)


@pytest.mark.parametrize("k", [10, 20])
def test_scatter_and_dense_masks_give_equal_ids(both_data, monkeypatch, k):
    """``SELFREC_TPU_EVAL_MASK=scatter`` ranks as the resident mask does, and
    as the JAX package's scatter path; the rec list too."""
    jd, td = both_data
    ue, ie = _embeddings(td, seed=k)
    args = (torch.from_numpy(ue), torch.from_numpy(ie), k)
    dense = ranking.topk_ids_from_embeddings(td, *args, block_size=16)
    rec_dense = ranking.rec_list_from_embeddings(td, *args, block_size=16)
    monkeypatch.setenv("SELFREC_TPU_EVAL_MASK", "scatter")
    scatter = ranking.topk_ids_from_embeddings(td, *args, block_size=16)
    np.testing.assert_array_equal(scatter, dense)
    np.testing.assert_array_equal(
        scatter, jax_ranking.topk_ids_from_embeddings(jd, ue, ie, k, block_size=16))
    assert ranking.rec_list_from_embeddings(td, *args, block_size=16) == rec_dense


def test_padded_lanes_are_dropped_never_scattered(both_data):
    """The last block is ragged, so the plan pads its rated lanes with row
    ``block_size``. Masking through the plan and through
    ``topk_scores_masked`` (which drops out-of-range lanes as JAX's
    ``mode="drop"`` does) never indexes a padded lane: an out-of-range
    ``index_put`` raises on the CPU (and asserts on CUDA). Both equal the
    top-k over the real lanes alone, and JAX's."""
    jd, td = both_data
    bs = 16
    plan = ranking.get_eval_plan(td, bs, "cpu")
    uids, rows, cols, valid = plan.blocks[-1]
    n = plan.n_rated[-1]
    assert valid < bs and n < rows.shape[0]
    with pytest.raises(IndexError):
        torch.zeros(bs, td.item_num)[rows, cols] = 1.0
    ue, ie = _embeddings(td, seed=2)
    ue_t, ie_t = torch.from_numpy(ue), torch.from_numpy(ie)
    got_s, got_i = ranking.topk_scores(ue_t[uids], ie_t, rows, cols, 10)
    want = ue_t[uids] @ ie_t.T
    want[rows[:n], cols[:n]] = ranking.MASK_VALUE
    want_s, want_i = ranking.topk_lowest_index(want, 10)
    assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
    jplan = jax_ranking.get_eval_plan(jd, bs)
    js, ji = jax_ranking.topk_scores(jnp.asarray(ue)[jplan.blocks[-1][0]], jnp.asarray(ie),
                                     jplan.blocks[-1][1], jplan.blocks[-1][2], 10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(js), rtol=1e-6)
    # negative rows and out-of-range items are dropped too
    bad_rows = torch.cat([rows, torch.tensor([-1, 0])])
    bad_cols = torch.cat([cols, torch.tensor([0, td.item_num])])
    s2, i2 = ranking.topk_scores_masked(ue_t[uids] @ ie_t.T, bad_rows, bad_cols, 10)
    assert torch.equal(i2, want_i)


@pytest.mark.parametrize("k", [5, 20])
def test_topk_lowest_index_is_lax_top_k_order(k):
    """Integer-valued rows tie everywhere; the order is value descending,
    then index ascending, with -0.0 below +0.0, -inf and the mask value
    last: lax.top_k's ids and values exactly."""
    import jax

    rng = np.random.default_rng(k)
    x = rng.integers(-3, 4, size=(64, 500)).astype(np.float32)
    x[:, ::7] = -0.0
    x[:, 5::11] = -np.inf
    x[:, 3::13] = ranking.MASK_VALUE
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = ranking.topk_lowest_index(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not torch.equal(torch.topk(torch.from_numpy(x), k).indices, ti)


def test_rec_list_from_score_fn_equals_jax_on_ties(both_data):
    """A score function whose scores tie heavily (KNN's ``s / (s + 1e-8)``
    saturates at 1.0): the rec list equals JAX's exactly, ids and scores."""
    jd, td = both_data
    rng = np.random.default_rng(8)
    table = rng.integers(0, 3, size=(td.user_num, td.item_num)).astype(np.float32)
    table = np.where(table > 0, table / (table + np.float32(1e-8)), np.float32(0))
    ref = jax_ranking.rec_list_from_score_fn(
        jd, lambda uids: jnp.asarray(table)[uids], 10, block_size=16)
    got = ranking.rec_list_from_score_fn(
        td, lambda uids: torch.from_numpy(table)[uids], 10, block_size=16)
    assert got == ref


def test_batched_full_rank_equals_jax(both_data):
    jd, td = both_data
    ue, ie = _embeddings(td, seed=4)
    ref = list(jax_ranking.batched_full_rank(
        jd.test_user_ids, lambda uids: jnp.asarray(ue)[uids], jnp.asarray(ie),
        jd.rated_offsets, jd.rated_items, 10, block_size=16))
    got = list(ranking.batched_full_rank(
        td.test_user_ids, lambda uids: torch.from_numpy(ue)[uids], torch.from_numpy(ie),
        td.rated_offsets, td.rated_items, 10, block_size=16))
    assert [u for u, _, _ in got] == [u for u, _, _ in ref]
    for (_, ti, ts), (_, ji, js) in zip(got, ref):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=1e-6)
