"""Samplers of the port (ops/sampling.py) against the JAX package.

The two packages draw from different generators, so the negative sampler
and the device shuffle are held to their invariants (never a rated item,
in range, a permutation with the right mask); the deterministic pieces
(bitmap packing, host batching from one numpy generator, unique_with_mask)
must be EQUAL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.ops import sampling as jax_sampling
from selfrec_tpu_torch.ops import sampling

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
