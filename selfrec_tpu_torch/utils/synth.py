"""Deterministic synthetic benchmark datasets.

The headline-benchmark dataset (yelp2018) is stripped from the reference
mount (reference/.MISSING_LARGE_BLOBS), so throughput benchmarks run on
a deterministic synthetic graph with yelp2018's published marginals
(31,668 users / 38,048 items / 1,561,406 interactions — SGL paper, Table 2).
Throughput of every op in the training path (SpMM over the fixed-nnz
adjacency, gathers, losses, Adam) depends only on shapes/nnz, not on which
edges exist, so this is a faithful perf stand-in; quality parity is a
separate concern validated on real data tests.
"""

from __future__ import annotations

import numpy as np

YELP2018_USERS = 31668
YELP2018_ITEMS = 38048
YELP2018_INTERACTIONS = 1561406


def synth_graph_arrays(
    n_users: int = YELP2018_USERS,
    n_items: int = YELP2018_ITEMS,
    n_interactions: int = YELP2018_INTERACTIONS,
    seed: int = 2018,
):
    """(train_users, train_items, test_users, test_items) int arrays."""
    rng = np.random.default_rng(seed)
    deg = np.clip(
        rng.lognormal(mean=np.log(n_interactions / n_users), sigma=1.0, size=n_users),
        3,
        2048,
    )
    deg = np.maximum((deg * (n_interactions / deg.sum())).astype(np.int64), 3)
    item_pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    item_pop /= item_pop.sum()

    users_col = np.repeat(np.arange(n_users), deg)
    items_col = rng.choice(n_items, size=len(users_col), p=item_pop)
    pair_key = users_col.astype(np.int64) * n_items + items_col
    _, uniq_idx = np.unique(pair_key, return_index=True)
    users_col = users_col[np.sort(uniq_idx)]
    items_col = items_col[np.sort(uniq_idx)]

    order = np.argsort(users_col, kind="stable")
    users_col, items_col = users_col[order], items_col[order]
    is_last = np.r_[users_col[:-1] != users_col[1:], True]
    return (
        users_col[~is_last],
        items_col[~is_last],
        users_col[is_last],
        items_col[is_last],
    )


def synth_graph_mapped(
    n_users: int = YELP2018_USERS,
    n_items: int = YELP2018_ITEMS,
    n_interactions: int = YELP2018_INTERACTIONS,
    seed: int = 2018,
):
    """(mapped_train, test_triples): train in the array-native 5-tuple form
    Interaction's fast path consumes, test as string triples."""
    tr_u, tr_i, te_u, te_i = synth_graph_arrays(
        n_users, n_items, n_interactions, seed
    )
    # ids must be FIRST-SEEN renumbered for parity with the triple path
    u_names = [f"u{u}" for u in dict.fromkeys(tr_u.tolist())]
    i_names = [f"i{i}" for i in dict.fromkeys(tr_i.tolist())]
    u_remap = np.full(n_users, -1, dtype=np.int32)
    i_remap = np.full(n_items, -1, dtype=np.int32)
    u_remap[[int(n[1:]) for n in u_names]] = np.arange(len(u_names))
    i_remap[[int(n[1:]) for n in i_names]] = np.arange(len(i_names))
    mapped = (
        u_remap[tr_u],
        i_remap[tr_i],
        np.ones(len(tr_u), dtype=np.float32),
        u_names,
        i_names,
    )
    test = [(f"u{u}", f"i{i}", 1.0) for u, i in zip(te_u, te_i)]
    return mapped, test


def synth_graph_triples(
    n_users: int = YELP2018_USERS,
    n_items: int = YELP2018_ITEMS,
    n_interactions: int = YELP2018_INTERACTIONS,
    seed: int = 2018,
    test_per_user: int = 1,
):
    """(train, test) lists of (user, item, weight) string triples.

    User degrees follow a lognormal clipped to [3, 2048]; item popularity is
    Zipf-like. Each user contributes ``test_per_user`` held-out items.
    """
    rng = np.random.default_rng(seed)
    deg = np.clip(
        rng.lognormal(mean=np.log(n_interactions / n_users), sigma=1.0, size=n_users),
        3,
        2048,
    )
    deg = np.maximum(
        (deg * (n_interactions / deg.sum())).astype(np.int64), 2 + test_per_user
    )
    item_pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    item_pop /= item_pop.sum()

    users_col = np.repeat(np.arange(n_users), deg)
    items_col = rng.choice(n_items, size=len(users_col), p=item_pop)
    # dedupe (user, item) pairs so the graph has no multi-edges
    pair_key = users_col.astype(np.int64) * n_items + items_col
    _, uniq_idx = np.unique(pair_key, return_index=True)
    users_col = users_col[np.sort(uniq_idx)]
    items_col = items_col[np.sort(uniq_idx)]

    # hold out the last interaction of each user as test
    order = np.argsort(users_col, kind="stable")
    users_col, items_col = users_col[order], items_col[order]
    is_last = np.r_[users_col[:-1] != users_col[1:], True]
    test_mask = is_last
    tr_u, tr_i = users_col[~test_mask], items_col[~test_mask]
    te_u, te_i = users_col[test_mask], items_col[test_mask]

    train = [(f"u{u}", f"i{i}", 1.0) for u, i in zip(tr_u, tr_i)]
    test = [(f"u{u}", f"i{i}", 1.0) for u, i in zip(te_u, te_i)]
    return train, test


# douban-book marginals (MHCN paper, Table 1): the social-model benchmark
# scale — its train/trust files are stripped from the reference mount too.
DOUBAN_USERS = 13024
DOUBAN_ITEMS = 22347
DOUBAN_INTERACTIONS = 792062
DOUBAN_RELATIONS = 169150


def synth_social_triples(
    n_users: int = DOUBAN_USERS,
    n_relations: int = DOUBAN_RELATIONS,
    seed: int = 1237,
):
    """Directed trust triples over the synthetic user population, follower
    counts Zipf-like (social graphs are heavier-tailed than interactions)."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, n_users + 1) ** 1.0
    pop /= pop.sum()
    src = rng.integers(0, n_users, size=int(n_relations * 1.1))
    dst = rng.choice(n_users, size=len(src), p=pop)
    keep = src != dst
    src, dst = src[keep][:n_relations], dst[keep][:n_relations]
    return [(f"u{u}", f"u{v}", 1.0) for u, v in zip(src, dst)]


def synth_sequences(
    n_seqs: int = 22363,
    n_items: int = 12101,
    mean_len: float = 8.8,
    seed: int = 77,
):
    """(train, test) dicts in the in-memory sequential format, with
    amazon-beauty's marginals by default (the reference's own sequential
    benchmark dataset, reference/dataset/amazon-beauty)."""
    rng = np.random.default_rng(seed)
    lens = np.clip(
        rng.lognormal(mean=np.log(mean_len), sigma=0.6, size=n_seqs), 3, 200
    ).astype(np.int64)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    pop /= pop.sum()
    train, test = {}, {}
    for s in range(n_seqs):
        items = rng.choice(n_items, size=lens[s] + 1, p=pop)
        train[f"s{s}"] = [f"i{i}" for i in items[:-1]]
        test[f"s{s}"] = [f"i{items[-1]}"]
    return train, test
