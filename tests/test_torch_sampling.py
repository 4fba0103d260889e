"""Samplers of the port (ops/sampling.py) against the JAX package.

The two packages draw from different generators, so the negative samplers
and the device shuffle are held to their invariants (never a rated item,
in range, a permutation with the right mask); the deterministic pieces
(bitmap packing, the CSR membership search, host batching from one numpy
generator, unique_with_mask) must be EQUAL, and so must the port's CSR and
bitmap samplers for one generator state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.ops import sampling as jax_sampling
from selfrec_tpu_torch.ops import sampling
from tests.test_torch_lightgcn import _conf_dict as lightgcn_conf

N_USERS, N_ITEMS = 50, 300


def _rated_csr(seed=0):
    """Per-user sorted rated items, 5-30 of 300 per user (density <= 10%)."""
    rng = np.random.default_rng(seed)
    offsets, items = [0], []
    for _ in range(N_USERS):
        k = int(rng.integers(5, 31))
        items.extend(np.sort(rng.choice(N_ITEMS, k, replace=False)).tolist())
        offsets.append(len(items))
    return np.asarray(offsets, np.int64), np.asarray(items, np.int32)


def test_pack_rated_bitmap_equals_jax():
    off, items = _rated_csr()
    np.testing.assert_array_equal(
        sampling.pack_rated_bitmap(off, items, N_USERS, N_ITEMS),
        jax_sampling.pack_rated_bitmap(off, items, N_USERS, N_ITEMS))


@pytest.mark.parametrize("shape", [(2000,), (500, 4)])
def test_bitmap_sampler_never_returns_a_rated_item(shape):
    off, items = _rated_csr(1)
    bitmap = sampling.bitmap_to_device(
        sampling.pack_rated_bitmap(off, items, N_USERS, N_ITEMS), "cpu")
    gen = torch.Generator().manual_seed(0)
    users = torch.randint(0, N_USERS, (shape[0],), generator=gen)
    neg = sampling.sample_negatives_bitmap(gen, users, bitmap, N_ITEMS, shape=shape,
                                           n_rounds=8)
    assert tuple(neg.shape) == shape
    assert int(neg.min()) >= 0 and int(neg.max()) < N_ITEMS
    per_user = users.repeat_interleave(shape[1]) if len(shape) == 2 else users
    rated = [set(items[off[u]:off[u + 1]].tolist()) for u in range(N_USERS)]
    flat = neg.reshape(-1).tolist()
    assert not any(c in rated[u] for u, c in zip(per_user.tolist(), flat))
    # uniform over the unrated catalog, roughly: most items are drawn
    assert len(set(flat)) > 0.8 * N_ITEMS


@pytest.mark.parametrize("case", ["dups", "with_minus_one", "all_distinct", "all_pad"])
def test_unique_with_mask_equals_jax(case):
    rng = np.random.default_rng(4)
    size = 64
    if case == "dups":
        idx = rng.integers(0, 20, size)
    elif case == "with_minus_one":
        idx = np.where(np.arange(size) < 40, rng.integers(0, 500, size), -1)
    elif case == "all_distinct":
        idx = rng.permutation(1000)[:size]
    else:
        idx = np.full(size, -1)
    idx = idx.astype(np.int64)
    ju, jm = jax_sampling.unique_with_mask(jnp.asarray(idx, jnp.int32), size)
    tu, tm = sampling.unique_with_mask(torch.from_numpy(idx), size)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_host_epoch_batches_equal_jax():
    rng = np.random.default_rng(0)
    eu = rng.integers(0, N_USERS, 1000).astype(np.int32)
    ei = rng.integers(0, N_ITEMS, 1000).astype(np.int32)
    got = sampling.epoch_pairwise_batches(np.random.default_rng(5), eu, ei, 128)
    ref = jax_sampling.epoch_pairwise_batches(np.random.default_rng(5), eu, ei, 128)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_device_epoch_batches_are_a_masked_permutation():
    rng = np.random.default_rng(1)
    n, bs = 1000, 128
    eu = torch.from_numpy(rng.integers(0, N_USERS, n).astype(np.int32))
    ei = torch.from_numpy(rng.integers(0, N_ITEMS, n).astype(np.int32))
    users, items, mask = sampling.epoch_pairwise_batches_device(
        torch.Generator().manual_seed(0), eu, ei, bs)
    assert users.shape == items.shape == mask.shape == (-(-n // bs), bs)
    valid = mask.reshape(-1) > 0
    assert int(valid.sum()) == n and bool(valid[:n].all())
    pairs = sorted(zip(users.reshape(-1)[valid].tolist(), items.reshape(-1)[valid].tolist()))
    assert pairs == sorted(zip(eu.tolist(), ei.tolist()))


def _csr_with_empty_segments():
    """Per-user sorted rated items with users 0, 7 and the last rating
    nothing, and user 3 rating one item."""
    off, items = _rated_csr(2)
    segs = [items[off[u]:off[u + 1]] for u in range(N_USERS)]
    segs[0] = segs[7] = segs[-1] = np.zeros(0, np.int32)
    segs[3] = np.asarray([299], np.int32)
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in segs])]).astype(np.int64)
    return offsets, np.concatenate(segs).astype(np.int32)


@pytest.mark.parametrize("extra_steps", [0, 3])
def test_searchsorted_in_segments_equals_jax(extra_steps):
    """Every (user, item) pair, including items below and above each
    segment and empty segments, at the least step count the trainer
    allows (ceil(log2(max_deg + 1))) and a few more; the answer is the
    true membership."""
    off, items = _csr_with_empty_segments()
    max_deg = int(np.diff(off).max())
    steps = int(np.ceil(np.log2(max_deg + 1))) + extra_steps
    seg = np.repeat(np.arange(N_USERS), N_ITEMS + 2).astype(np.int32)
    vals = np.tile(np.arange(-1, N_ITEMS + 1), N_USERS).astype(np.int32)
    ref = np.asarray(jax_sampling.searchsorted_in_segments(
        jnp.asarray(items), jnp.asarray(off.astype(np.int32)), jnp.asarray(seg),
        jnp.asarray(vals), steps))
    got = sampling.searchsorted_in_segments(
        torch.from_numpy(items), torch.from_numpy(off), torch.from_numpy(seg),
        torch.from_numpy(vals).long(), steps)
    np.testing.assert_array_equal(got.numpy(), ref)
    truth = np.array([v in set(items[off[s]:off[s + 1]].tolist()) for s, v in zip(seg, vals)])
    np.testing.assert_array_equal(got.numpy(), truth)


@pytest.mark.parametrize("shape", [(2000,), (500, 64)])
def test_csr_sampler_equals_the_bitmap_sampler(shape):
    """One generator seed, the same draws in the same order: the CSR
    sampler returns the bitmap sampler's negatives bit for bit, none of
    them rated (per-user density <= 10%, so a lane left rated after 8
    rounds has probability <= 1e-9)."""
    off, items = _rated_csr(3)
    bitmap = sampling.bitmap_to_device(
        sampling.pack_rated_bitmap(off, items, N_USERS, N_ITEMS), "cpu")
    users = torch.randint(0, N_USERS, (shape[0],), generator=torch.Generator().manual_seed(1))
    keys = sampling.rated_keys(torch.from_numpy(off), torch.from_numpy(items), N_ITEMS)
    csr = sampling.sample_negatives(torch.Generator().manual_seed(9), users, keys, N_ITEMS,
                                    shape=shape, n_rounds=8)
    bm = sampling.sample_negatives_bitmap(torch.Generator().manual_seed(9), users, bitmap,
                                          N_ITEMS, shape=shape, n_rounds=8)
    assert tuple(csr.shape) == shape
    assert torch.equal(csr, bm)
    per_user = users.repeat_interleave(shape[1]) if len(shape) == 2 else users
    rated = [set(items[off[u]:off[u + 1]].tolist()) for u in range(N_USERS)]
    assert not any(c in rated[u] for u, c in zip(per_user.tolist(), csr.reshape(-1).tolist()))


def test_rated_keys_membership_equals_the_segment_search():
    """The CSR sampler's membership (one searchsorted over the sorted keys
    ``user * n_items + item``) equals the JAX package's segment search
    (``searchsorted_in_segments``) on every (user, item) lane, empty
    segments included."""
    off, items = _csr_with_empty_segments()
    keys = sampling.rated_keys(torch.from_numpy(off), torch.from_numpy(items), N_ITEMS)
    assert bool((keys[1:] > keys[:-1]).all())
    seg = torch.from_numpy(np.repeat(np.arange(N_USERS), N_ITEMS))
    vals = torch.from_numpy(np.tile(np.arange(N_ITEMS), N_USERS))
    steps = int(np.ceil(np.log2(int(np.diff(off).max()) + 1))) + 1
    want = sampling.searchsorted_in_segments(torch.from_numpy(items), torch.from_numpy(off),
                                             seg, vals, steps)
    q = seg * N_ITEMS + vals
    got = keys[torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)] == q
    assert torch.equal(got, want) and bool(want.any()) and not bool(want.all())


def test_pointwise_batches_equal_jax():
    rng = np.random.default_rng(2)
    eu = rng.integers(0, N_USERS, 700).astype(np.int32)
    ei = rng.integers(0, N_ITEMS, 700).astype(np.int32)
    got = sampling.epoch_pointwise_batches(np.random.default_rng(6), eu, ei, N_ITEMS, 256,
                                           n_negs=3)
    ref = jax_sampling.epoch_pointwise_batches(np.random.default_rng(6), eu, ei, N_ITEMS, 256,
                                               n_negs=3)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _lightgcn_pair(dataset):
    from selfrec_tpu.config import ModelConf as JaxConf
    from selfrec_tpu.models.graph.lightgcn import LightGCN as JaxLightGCN
    from selfrec_tpu_torch.config import ModelConf
    from selfrec_tpu_torch.models.graph.lightgcn import LightGCN

    train, test = dataset
    return (JaxLightGCN(JaxConf(lightgcn_conf()), train, test),
            LightGCN(ModelConf(lightgcn_conf()), train, test, device="cpu"))


@pytest.mark.parametrize("epoch", [0, 3])
def test_host_batches_knob_gives_jax_host_batches(monkeypatch, tiny_graph_dataset, epoch):
    """``SELFREC_TPU_HOST_BATCHES=1``: the trainer's batches are the JAX
    package's host batches (base.py:583-592) for the same (seed, epoch),
    element for element; unset, the device shuffle stays the default."""
    jm, tm = _lightgcn_pair(tiny_graph_dataset)
    ref = jax_sampling.epoch_pairwise_batches(jm.epoch_rng(epoch), jm.data.edge_users,
                                              jm.data.edge_items, jm.batch_size)
    monkeypatch.setenv("SELFREC_TPU_HOST_BATCHES", "1")
    got = tm.epoch_batches(epoch)
    for a, b in zip(got, ref):
        assert a.device == tm.device
        np.testing.assert_array_equal(a.numpy(), b)
    monkeypatch.delenv("SELFREC_TPU_HOST_BATCHES")
    device = tm.epoch_batches(epoch)
    assert not np.array_equal(device[0].numpy(), ref[0])


def test_over_budget_bitmap_builds_the_csr_sampler(monkeypatch, tiny_graph_dataset):
    """A bitmap over ``SELFREC_TPU_NEG_BITMAP_MB`` takes the CSR branch
    (base.py:453-471, 508-527), over the JAX package's rated CSR; it
    searches the CSR's sorted keys (``user * n_items + item``), and draws
    the bitmap model's negatives from the same generator state."""
    jm, tm = _lightgcn_pair(tiny_graph_dataset)
    monkeypatch.setenv("SELFREC_TPU_NEG_BITMAP_MB", "0.0001")
    tm.build()
    assert tm._rated_bitmap is None
    rows = np.repeat(np.arange(tm.data.user_num), np.diff(np.asarray(jm._rated_offsets)))
    np.testing.assert_array_equal(tm._rated_keys.numpy(),
                                  rows * tm.data.item_num + np.asarray(jm._rated_items))
    np.testing.assert_array_equal(tm._rated_items.numpy(), np.asarray(jm._rated_items))
    np.testing.assert_array_equal(tm._rated_offsets.numpy(), np.asarray(jm._rated_offsets))
    monkeypatch.delenv("SELFREC_TPU_NEG_BITMAP_MB")
    _, bm = _lightgcn_pair(tiny_graph_dataset)
    bm.build()
    assert bm._rated_bitmap is not None
    users = torch.from_numpy(tm.data.edge_users[:300].astype(np.int64))
    tm.generator.manual_seed(5)
    bm.generator.manual_seed(5)
    assert torch.equal(tm.sample_negatives(users), bm.sample_negatives(users))
