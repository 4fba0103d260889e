"""Full-rank eval of the port (ops/ranking.py, utils/metrics.py) against the
JAX package on the same embeddings.

Embeddings are continuous random values from numpy, so no two scores tie
and both top-k orders are defined (lax.top_k and torch.topk may order ties
differently). Item ids and metric strings must be EQUAL; scores are the
same f32 dot products summed in another order, rtol 1e-6. The scatter-mask
plan's arrays are EQUAL to JAX's, and score-function ranking, which breaks
ties by the lowest index as lax.top_k does, gives JAX's rec list EXACTLY
on scores built to tie. The fused top-k's plain twin
(ops/rank_topk.py ``rank_topk_plain``, the two stages of the card's
kernels) gives the JAX package's dense-mask scan; on integer scores, which
tie everywhere, it gives ``topk_lowest_index`` over the whole masked
matrix EXACTLY."""

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
from selfrec_tpu_torch.ops import rank_topk, ranking
from selfrec_tpu_torch.utils import metrics
from selfrec_tpu_torch.utils.synth import synth_graph_mapped

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
    hits = []
    top = ranking.topk_ids_from_embeddings(td, torch.from_numpy(ue),
                                           torch.from_numpy(ie), 20, hits_out=hits)
    offsets, items = td.test_gt_csr()
    got = metrics.ranking_evaluation_ids(offsets, items, top, [5, 10, 20], hits[0])
    ref = jax_metrics.ranking_evaluation_ids(offsets, items, top, [5, 10, 20],
                                             td.item_num)
    assert got == ref
    rec = ranking.rec_list_from_embeddings(td, torch.from_numpy(ue),
                                           torch.from_numpy(ie), 20)
    assert metrics.ranking_evaluation(td.test_set, rec, [5, 10, 20]) == got
    assert jax_metrics.ranking_evaluation(jd.test_set, rec, [5, 10, 20]) == got


def _gt_case(seed, n_users, n_items, k, all_miss):
    """Ground truth of 1 to 300 items a user in insertion order (not sorted)
    and top-k lists biased toward it, or drawn only outside it; the string
    path's inputs, the CSR and the hit mask by set membership."""
    rng = np.random.default_rng(seed)
    origin, res = {}, {}
    offsets = np.zeros(n_users + 1, dtype=np.int64)
    gt_items, top_rows, mask_rows = [], [], []
    for u in range(n_users):
        gt = rng.choice(n_items, size=int(rng.integers(1, 301)), replace=False)
        if np.all(np.diff(gt) > 0):
            gt = gt[::-1]  # insertion order other than sorted wherever it can be
        origin[f"u{u}"] = {f"i{i}": 1 for i in gt}
        gt_items.extend(gt)
        offsets[u + 1] = len(gt_items)
        outside = np.setdiff1d(np.arange(n_items), gt)
        n_hits = 0 if all_miss else int(rng.integers(0, min(k, len(gt)) + 1))
        top = rng.permutation(np.concatenate([rng.choice(gt, n_hits, replace=False),
                                              rng.choice(outside, k - n_hits, replace=False)]))
        res[f"u{u}"] = [(f"i{i}", 1.0 - r * 0.001) for r, i in enumerate(top)]
        top_rows.append(top)
        gt_set = set(gt.tolist())
        mask_rows.append([int(i) in gt_set for i in top])
    return (origin, res, offsets, np.asarray(gt_items), np.asarray(top_rows, dtype=np.int64),
            np.asarray(mask_rows, dtype=bool))


@pytest.mark.parametrize("all_miss", [False, True])
@pytest.mark.parametrize("k, top_ns", [(1, [1]), (5, [1, 5]), (20, [5, 10, 20]),
                                       (128, [20, 50, 128])])
def test_metric_strings_from_the_hit_mask_equal_jax_and_the_string_path(
        k, top_ns, all_miss):
    """``ranking_evaluation_ids`` from the hit mask alone gives the strings
    of the JAX package's ``ranking_evaluation_ids`` on the same ids, which
    searches the ground truth itself, and of the string path, over ground
    truths of 1 to 300 items in an order other than sorted."""
    origin, res, offsets, items, top, mask = _gt_case(k, 60, 900, k, all_miss)
    assert mask.any() != all_miss
    want = jax_metrics.ranking_evaluation_ids(offsets, items, top, top_ns, 900)
    assert metrics.ranking_evaluation(origin, res, top_ns) == want
    assert metrics.ranking_evaluation_ids(offsets, items, top, top_ns, mask) == want


def test_metric_strings_from_the_hit_mask_still_check_their_inputs():
    """A user with no ground truth raises ZeroDivisionError, a length
    mismatch and a mask of another shape raise ValueError."""
    top = np.zeros((2, 3), np.int64)
    mask = np.zeros((2, 3), bool)
    with pytest.raises(ZeroDivisionError):
        metrics.ranking_evaluation_ids(np.array([0, 2, 2]), np.array([1, 2]), top, [3], mask)
    with pytest.raises(ValueError):
        metrics.ranking_evaluation_ids(np.array([0, 1, 2, 3]), np.array([0, 1, 2]), top, [3],
                                       mask)
    with pytest.raises(ValueError):
        metrics.ranking_evaluation_ids(np.array([0, 1, 2]), np.array([0, 1]), top, [3],
                                       mask[:, :2])


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


@pytest.fixture(scope="module")
def wide_data():
    """Both packages' Interaction over one graph of 300 users and 1,000
    items: enough items for slices that do not divide the catalog and for
    k past the kernels' K_MAX."""
    train, test = synth_graph_mapped(300, 1000, 8000, seed=11)
    return (JaxInteraction(JaxConf(dict(CONF)), train, test),
            Interaction(ModelConf(dict(CONF)), train, test))


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("k", [10, 20])
def test_rank_topk_plain_equals_jax_dense_scan(wide_data, k, d):
    """7 slices of 143 items (the last 142): ids equal to the JAX package's
    ``_topk_all_blocks_dense`` (lax.top_k's order), scores within rtol 1e-6
    (the same f32 products summed in another order)."""
    jd, td = wide_data
    ue, ie = _embeddings(td, seed=k + d, d=d)
    jplan = jax_ranking.get_eval_plan(jd, 64)
    jscs, jids = jax_ranking._topk_all_blocks_dense(
        jnp.asarray(ue), jnp.asarray(ie), jplan.uids_all, jax_ranking.get_rated_dense(jd), k)
    plan = ranking.get_eval_plan(td, 64, "cpu")
    rated = ranking.get_rated_dense(td, "cpu")
    scs, ids = rank_topk.rank_topk_plain(torch.from_numpy(ue), torch.from_numpy(ie), rated,
                                         plan.uids, k, slices=7)
    n = len(plan.user_ids)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids).reshape(-1, k)[:n])
    np.testing.assert_allclose(scs.numpy(), np.asarray(jscs).reshape(-1, k)[:n], rtol=1e-6)


def _integer_case(seed, n_users=40, n_items=90, d=6, rated_share=0.3):
    """Integer embeddings (every score an exact small integer, so scores tie
    everywhere and sum alike in any order) and a random rated incidence."""
    rng = np.random.default_rng(seed)
    ue = torch.from_numpy(rng.integers(-2, 3, size=(n_users, d)).astype(np.float32))
    ie = torch.from_numpy(rng.integers(-2, 3, size=(n_items, d)).astype(np.float32))
    rated = torch.from_numpy((rng.random((n_users, n_items)) < rated_share).astype(np.int8))
    uids = torch.from_numpy(rng.permutation(n_users)[:25].astype(np.int64))
    return ue, ie, rated, uids


def _masked_reference(ue, ie, rated, uids, k):
    """topk_lowest_index over the whole masked score matrix."""
    full = torch.where(rated[uids] != 0, ranking.MASK_VALUE, ue[uids] @ ie.T)
    return ranking.topk_lowest_index(full, k)


@pytest.mark.parametrize("slices", [1, 4, 7, 90])
@pytest.mark.parametrize("k", [5, 20])
def test_rank_topk_plain_ties_by_the_lowest_id(slices, k):
    """Scores that tie everywhere: any slice count gives the whole masked
    matrix's top-k in lax.top_k's order, ids and values exactly."""
    ue, ie, rated, uids = _integer_case(seed=slices + k)
    got_s, got_i = rank_topk.rank_topk_plain(ue, ie, rated, uids, k, slices=slices)
    want_s, want_i = _masked_reference(ue, ie, rated, uids, k)
    assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)


@pytest.mark.parametrize("slices", [1, 3, 7])
def test_rank_topk_plain_short_user_gets_rated_items_lowest_id_first(slices):
    """A user with 3 unrated items and k = 10: the 3 by score, then 7 rated
    items at exactly -1e9, lowest ids first."""
    ue, ie, rated, uids = _integer_case(seed=3)
    uids = uids[:4].clone()
    u = int(uids[0])
    unrated = [5, 41, 77]
    rated[u] = 1
    rated[u, unrated] = 0
    scs, ids = rank_topk.rank_topk_plain(ue, ie, rated, uids, 10, slices=slices)
    order = sorted(unrated, key=lambda i: (-float(ue[u] @ ie[i]), i))
    assert ids[0, :3].tolist() == order
    assert ids[0, 3:].tolist() == [i for i in range(90) if i not in unrated][:7]
    assert scs[0, 3:].tolist() == [ranking.MASK_VALUE] * 7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_topk_plain_returns_no_rated_item_while_k_unrated_exist(seed):
    """Users who rated most of the catalog (up to 85 of 90 items), k = 5:
    no returned item is rated and none repeats."""
    ue, ie, rated, uids = _integer_case(seed=seed, rated_share=0.9)
    rated[:, :5] = 0  # every user keeps at least 5 unrated items
    scs, ids = rank_topk.rank_topk_plain(ue, ie, rated, uids, 5, slices=4)
    assert not bool(rated[uids[:, None], ids].any())
    assert all(len(set(row)) == 5 for row in ids.tolist())
    assert bool((scs > ranking.MASK_VALUE).all())


def test_sort_keys_round_trip_and_order():
    """Keys decode to the values bit for bit and the ids; descending keys
    order values descending, -0.0 below +0.0, ties by the lowest id."""
    v = torch.tensor([1.5, -0.0, 0.0, -np.inf, np.inf, ranking.MASK_VALUE, 1.5, -2.0],
                     dtype=torch.float32)
    ids = torch.arange(8, dtype=torch.int64) * 1000
    keys = rank_topk.sort_keys(v, ids)
    assert torch.equal(rank_topk.key_values(keys).view(torch.int32), v.view(torch.int32))
    assert torch.equal(rank_topk.key_ids(keys), ids)
    order = torch.argsort(keys, descending=True).tolist()
    assert order == [4, 0, 6, 2, 1, 7, 5, 3]


@pytest.mark.parametrize("case", ["wrong_dtype", "int32_rated", "int32_uids", "non_contiguous",
                                  "k_over_max", "k_zero", "k_over_items", "widths_differ",
                                  "rated_shape", "gt_int64_items", "gt_int32_offsets",
                                  "gt_rows", "gt_other_device"])
def test_rank_topk_wrapper_refuses_what_the_kernel_does_not_take(case):
    ue, ie, rated, uids = _integer_case(seed=4, n_items=200)
    k = 10
    gt = None
    if case.startswith("gt_"):
        offsets, items = _gt_csr(np.random.default_rng(4), uids.shape[0], 200)
        if case == "gt_int64_items":
            items = items.long()
        elif case == "gt_int32_offsets":
            offsets = offsets.int()
        elif case == "gt_rows":
            offsets = offsets[:-1]
        elif case == "gt_other_device":
            items = items.to("meta")
        gt = (offsets, items)
        with pytest.raises((TypeError, ValueError)):
            rank_topk.rank_topk_plain(ue, ie, rated, uids, k, gt=gt)
    if case == "wrong_dtype":
        ue = ue.double()
    elif case == "int32_rated":
        rated = rated.int()
    elif case == "int32_uids":
        uids = uids.int()
    elif case == "non_contiguous":
        ie = torch.cat([ie, ie], dim=1)[:, ::2]
    elif case == "k_over_max":
        k = rank_topk.K_MAX + 1
    elif case == "k_zero":
        k = 0
    elif case == "k_over_items":
        ie, rated, k = ie[:8], rated[:, :8].contiguous(), 9
    elif case == "widths_differ":
        ie = ie[:, :5].contiguous()
    elif case == "rated_shape":
        rated = rated[:, :100].contiguous()
    with pytest.raises((TypeError, ValueError)):
        rank_topk.rank_topk(ue, ie, rated, uids, k, gt=gt)


def _gt_csr(rng, n, n_items, longest=300, ids=None):
    """A ground-truth CSR (offsets int64, items int32 ascending in a row)
    of 0 to ``longest`` items a row; with ``ids`` (n, k), each row also
    holds a random share of its row of ids."""
    offsets, items = [0], []
    for r in range(n):
        row = rng.choice(n_items, size=int(rng.integers(0, min(longest, n_items) + 1)),
                         replace=False)
        if ids is not None:
            row = np.union1d(row, ids[r][rng.random(ids.shape[1]) < rng.random()])
        items.extend(np.sort(row))
        offsets.append(len(items))
    return (torch.tensor(offsets, dtype=torch.int64),
            torch.tensor(np.asarray(items, dtype=np.int32), dtype=torch.int32))


def _membership(ids, offsets, items):
    """The hit mask by Python sets: the host's answer."""
    rows = [set(items[offsets[r]:offsets[r + 1]].tolist()) for r in range(ids.shape[0])]
    return torch.tensor([[int(i) in rows[r] for i in ids[r]] for r in range(ids.shape[0])],
                        dtype=torch.bool).reshape(ids.shape)


@pytest.mark.parametrize("k", [1, 5, 20, 128, 130])
def test_rank_topk_plain_hit_mask_is_membership_of_its_own_ids(k):
    """Given the ground truth (rows of 0 to 300 items, some holding a share
    of the row's answer, some none of it), the plain twin returns the same
    scores and ids as without it and a mask equal to the host's membership
    test of those ids, past the kernels' K_MAX too."""
    rng = np.random.default_rng(k)
    ue = torch.from_numpy(rng.normal(size=(120, 8)).astype(np.float32))
    ie = torch.from_numpy(rng.normal(size=(700, 8)).astype(np.float32))
    rated = torch.from_numpy((rng.random((120, 700)) < 0.2).astype(np.int8))
    uids = torch.from_numpy(rng.permutation(120)[:90].astype(np.int64))
    scs, ids = rank_topk.rank_topk_plain(ue, ie, rated, uids, k, slices=3)
    gt = _gt_csr(rng, 90, 700, ids=ids.numpy())
    gscs, gids, hits = rank_topk.rank_topk_plain(ue, ie, rated, uids, k, slices=3, gt=gt)
    assert torch.equal(gscs, scs) and torch.equal(gids, ids)
    assert hits.dtype == torch.bool
    want = _membership(ids, *gt)
    assert torch.equal(hits, want)
    assert bool(want.any()) and not bool(want.all(dim=1).all())


def test_hits_plain_on_empty_rows_and_an_empty_ground_truth():
    """Rows with no ground truth hit nothing; so does every row of an empty
    one."""
    ids = torch.tensor([[3, 4, 5], [1, 2, 9], [7, 8, 0]])
    offsets = torch.tensor([0, 0, 3, 3])
    items = torch.tensor([2, 5, 9], dtype=torch.int32)
    assert rank_topk.hits_plain(ids, offsets, items).tolist() == [
        [False] * 3, [False, True, True], [False] * 3]
    empty = rank_topk.hits_plain(ids, torch.zeros(4, dtype=torch.int64),
                                 torch.zeros(0, dtype=torch.int32))
    assert not bool(empty.any())


@pytest.mark.parametrize("case", ["cpu_dense", "scatter_mask", "k_over_max"])
def test_topk_ids_fill_the_hit_mask_on_every_route(wide_data, monkeypatch, case):
    """The out-parameter changes no id. On each route (the plain twin, the
    scatter scan, the plain twin past the kernels' K_MAX) the call appends
    one host bool mask equal to the membership of its ids in the test
    users' ground truth."""
    _, td = wide_data
    k = rank_topk.K_MAX + 2 if case == "k_over_max" else 20
    if case == "scatter_mask":
        monkeypatch.setenv("SELFREC_TPU_EVAL_MASK", "scatter")
    ue, ie = (torch.from_numpy(a) for a in _embeddings(td, seed=22))
    hits = []
    ids = ranking.topk_ids_from_embeddings(td, ue, ie, k, block_size=64, hits_out=hits)
    np.testing.assert_array_equal(
        ids, ranking.topk_ids_from_embeddings(td, ue, ie, k, block_size=64))
    (mask,) = hits
    assert isinstance(mask, np.ndarray) and mask.dtype == bool and mask.shape == ids.shape
    offsets, items = td.test_gt_csr()
    want = _membership(torch.from_numpy(ids), offsets, torch.from_numpy(items)).numpy()
    np.testing.assert_array_equal(mask, want)
    assert want.any()
    g_off, g_items = ranking.get_test_gt(td, "cpu")
    assert g_items.dtype == torch.int32 and torch.equal(g_off, torch.from_numpy(offsets))


def test_fast_measure_strings_equal_on_the_host_and_the_device_hit_test(monkeypatch):
    """``_fast_measure`` on the CPU: the scatter mask's route and the
    resident mask's each test their own ids; the strings are equal to each
    other, to the string path's and to the JAX package's
    ``ranking_evaluation_ids`` on the same ids."""
    from selfrec_tpu_torch.models import get_model_class

    train, test = synth_graph_mapped(300, 1000, 8000, seed=11)
    conf = dict(CONF, model={"name": "MF", "type": "graph"})
    model = get_model_class("MF")(ModelConf(conf), train, test, device="cpu")
    ue, ie = (torch.from_numpy(a) for a in _embeddings(model.data, seed=23))
    model.user_emb, model.item_emb = ue, ie
    monkeypatch.setenv("SELFREC_TPU_EVAL_MASK", "scatter")
    scatter = model._fast_measure()
    monkeypatch.delenv("SELFREC_TPU_EVAL_MASK")
    resident = model._fast_measure()
    assert resident == scatter
    assert resident == metrics.ranking_evaluation(model.data.test_set, model.test(), [10])
    ids = ranking.topk_ids_from_embeddings(model.data, ue, ie, 10,
                                           block_size=model.eval_block_size)
    assert resident == jax_metrics.ranking_evaluation_ids(*model.data.test_gt_csr(), ids, [10],
                                                          model.data.item_num)


def test_rank_topk_launches_on_the_card_only():
    """The kernels' wrapper takes CUDA tensors alone: CPU ones, which the
    eval hands to the plain twin, raise and count no launch."""
    ue, ie, rated, uids = _integer_case(seed=5)
    before = rank_topk.rank_topk.launches
    with pytest.raises(RuntimeError, match="rank_topk_plain"):
        rank_topk.rank_topk(ue, ie, rated, uids, 10)
    assert rank_topk.rank_topk.launches == before


def _spy_paths(monkeypatch):
    """Record which ranking path ``_ranked`` takes, each still computing."""
    taken = []
    for mod, name in ((rank_topk, "rank_topk_plain"), (ranking, "_topk_all_blocks"),
                      (ranking, "_topk_all_blocks_dense")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            taken.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return taken


@pytest.mark.parametrize("case", ["cpu_dense", "scatter_mask", "k_over_max"])
def test_ranked_dispatch(wide_data, monkeypatch, case):
    """CPU inputs with the resident mask take the plain twin, at k past
    the kernels' K_MAX too (on the card that k takes the dense-mask block
    scan); the scatter mask takes the scatter scan. Each answers as the JAX
    package does."""
    jd, td = wide_data
    k = rank_topk.K_MAX + 2 if case == "k_over_max" else 20
    if case == "scatter_mask":
        monkeypatch.setenv("SELFREC_TPU_EVAL_MASK", "scatter")
    ue, ie = _embeddings(td, seed=21)
    taken = _spy_paths(monkeypatch)
    ids = ranking.topk_ids_from_embeddings(td, torch.from_numpy(ue), torch.from_numpy(ie), k,
                                           block_size=64)
    assert taken == {"cpu_dense": ["rank_topk_plain"], "scatter_mask": ["_topk_all_blocks"],
                     "k_over_max": ["rank_topk_plain"]}[case]
    np.testing.assert_array_equal(
        ids, jax_ranking.topk_ids_from_embeddings(jd, ue, ie, k, block_size=64))
