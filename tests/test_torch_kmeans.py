"""k-means of the port (selfrec_tpu_torch.ops.kmeans) against the JAX
package's (selfrec_tpu/ops/kmeans.py), from the same initial rows
(``jax.random.choice(key, n, (k,), replace=n < k)``, fed to the port).

- Well-separated clusters: the same assignments exactly after 25
  iterations, centroids within rtol 1e-5 / atol 1e-6.
- Random data: one iteration. An assignment may flip where a point's two
  best distances lie within the packages' largest distance difference;
  such points (a margin of twice the largest difference) are left out and
  every other assignment must be equal.
- Ties pick the first centroid, and an empty cluster keeps its centroid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.ops.kmeans import kmeans as jax_kmeans
from selfrec_tpu_torch.ops.kmeans import kmeans


def _init_idx(key, n, k):
    return np.asarray(jax.random.choice(key, n, shape=(k,), replace=n < k))


def _both(x, k, key, n_iters=25):
    jc, ja = jax_kmeans(key, jnp.asarray(x), k, n_iters=n_iters)
    tc, ta = kmeans(torch.from_numpy(x), k, n_iters=n_iters,
                    init_idx=torch.from_numpy(_init_idx(key, x.shape[0], k)))
    return (np.asarray(jc), np.asarray(ja)), (tc.numpy(), ta.numpy())


def test_separated_clusters_match_jax_exactly():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, 16)).astype(np.float32) * 10.0
    labels = rng.integers(0, 6, 900)
    x = (centers[labels] + 0.05 * rng.normal(size=(900, 16))).astype(np.float32)
    (jc, ja), (tc, ta) = _both(x, 6, jax.random.PRNGKey(3))
    assert ta.dtype == np.int32 and tc.shape == (6, 16)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_one_iteration_on_random_data_matches_jax_away_from_ties(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1500, 16)).astype(np.float32)
    k = 40
    key = jax.random.PRNGKey(seed)
    (jc, ja), (tc, ta) = _both(x, k, key, n_iters=1)
    # JAX's distances to its final centroids, and the port's to the same
    cj = jnp.asarray(jc)
    dj = np.asarray(jnp.sum(jnp.asarray(x) ** 2, 1)[:, None] - 2.0 * (jnp.asarray(x) @ cj.T)
                    + jnp.sum(cj * cj, 1)[None])
    xt, ct = torch.from_numpy(x), torch.from_numpy(jc)
    dt = ((xt * xt).sum(1)[:, None] - 2.0 * (xt @ ct.T) + (ct * ct).sum(1)[None]).numpy()
    two = np.sort(dj, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > 2 * np.abs(dt - dj).max()
    assert clear.mean() > 0.99
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ta[clear], ja[clear])


def test_ties_pick_the_first_centroid_and_empty_clusters_keep_theirs():
    """Rows 0 and 1 are equal, so centroids 0 and 1 start equal: every
    point nearest to them goes to 0 (the first minimum, as jnp.argmin),
    and after one iteration the empty cluster 1 keeps its initial row
    while cluster 0 moves to its points' mean."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(200, 8)).astype(np.float32)
    x[1] = x[0]
    xt, idx = torch.from_numpy(x), torch.tensor([0, 1, 2, 3, 4])
    _, first = kmeans(xt, 5, n_iters=0, init_idx=idx)
    c0 = jnp.asarray(x[:5])
    d = (jnp.sum(jnp.asarray(x) ** 2, 1)[:, None] - 2.0 * (jnp.asarray(x) @ c0.T)
         + jnp.sum(c0 * c0, 1)[None])
    np.testing.assert_array_equal(first.numpy(), np.asarray(jnp.argmin(d, axis=1)))
    assert int((first == 0).sum()) > 0 and not bool((first == 1).any())
    cents, _ = kmeans(xt, 5, n_iters=1, init_idx=idx)
    assert torch.equal(cents[1], xt[1])
    torch.testing.assert_close(cents[0], xt[first == 0].mean(0), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,k", [(300, 20), (10, 20)])
def test_initial_rows_are_sampled_without_replacement_unless_n_below_k(n, k):
    x = torch.randn(n, 4, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(5)
    cents, assign = kmeans(x, k, n_iters=0, generator=gen)
    gen = torch.Generator().manual_seed(5)
    idx = (torch.randint(0, n, (k,), generator=gen) if n < k
           else torch.randperm(n, generator=gen)[:k])
    assert torch.equal(cents, x[idx])
    if n >= k:
        assert len(set(idx.tolist())) == k
    assert assign.shape == (n,) and int(assign.max()) < k
