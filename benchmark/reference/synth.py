"""Synthetic data at published marginals, made from a seed.

A frozen copy of the port's ``utils/synth.py`` generators, kept here so
that the yardstick does not move when the port does. The datasets
themselves are not in the repository; every op of the training and eval
paths depends on the shapes and the number of interactions, not on which
edges exist, so data at the published marginals stands in for them.

Both generators hand back integer arrays already numbered as the port
numbers them (first seen, in training order), so that the harness can
give the same ids to the program and to the reference.
"""

from __future__ import annotations

import numpy as np


def _first_seen(ids: np.ndarray) -> np.ndarray:
    """The distinct values of ``ids`` in the order they first appear."""
    _, first = np.unique(ids, return_index=True)
    return ids[np.sort(first)]


def graph_arrays(seed: int, users: int, items: int, interactions: int, structure_seed: int):
    """A user-item graph with the given marginals (``synth_graph_arrays``):
    user degrees lognormal, clipped to [3, 2048] and rescaled to the
    interaction count; item popularity Zipf-like (exponent 0.8); repeated
    pairs dropped; each user's last interaction held out for test.

    The graph is drawn from ``structure_seed``; ``seed`` relabels its users
    and items by two permutations. So every seed has the same sizes, the
    same degrees and the same held-out pairs, in another order, and the
    work of a step or an eval does not change with the seed.

    Returns a dict of int64 arrays: ``train_u``, ``train_i`` (ids numbered
    first seen over the training edges), ``test_u``, ``test_i`` (test pairs
    whose user and item both occur in training), and ``n_users``,
    ``n_items``."""
    rng = np.random.default_rng(structure_seed)
    deg = np.clip(rng.lognormal(mean=np.log(interactions / users), sigma=1.0, size=users),
                  3, 2048)
    deg = np.maximum((deg * (interactions / deg.sum())).astype(np.int64), 3)
    pop = 1.0 / np.arange(1, items + 1) ** 0.8
    pop /= pop.sum()
    u = np.repeat(np.arange(users), deg)
    i = rng.choice(items, size=len(u), p=pop)
    _, uniq = np.unique(u.astype(np.int64) * items + i, return_index=True)
    keep = np.sort(uniq)
    relabel = np.random.default_rng(seed)
    u, i = relabel.permutation(users)[u[keep]], relabel.permutation(items)[i[keep]]
    order = np.argsort(u, kind="stable")
    u, i = u[order], i[order]
    is_last = np.r_[u[:-1] != u[1:], True]
    tr_u, tr_i, te_u, te_i = u[~is_last], i[~is_last], u[is_last], i[is_last]

    u_order, i_order = _first_seen(tr_u), _first_seen(tr_i)
    u_map = np.full(users, -1, dtype=np.int64)
    i_map = np.full(items, -1, dtype=np.int64)
    u_map[u_order] = np.arange(len(u_order))
    i_map[i_order] = np.arange(len(i_order))
    te_keep = (u_map[te_u] >= 0) & (i_map[te_i] >= 0)
    return {"train_u": u_map[tr_u], "train_i": i_map[tr_i],
            "test_u": u_map[te_u[te_keep]], "test_i": i_map[te_i[te_keep]],
            "n_users": len(u_order), "n_items": len(i_order)}


def sequences(seed: int, n_seqs: int, n_items: int, mean_len: float, structure_seed: int):
    """Item sequences with the given marginals (``synth_sequences``):
    lengths lognormal (sigma 0.6) clipped to [3, 200], items Zipf-like
    (exponent 0.8); each sequence's last item is its test target. Drawn in
    two array calls, not one a sequence.

    The sequences are drawn from ``structure_seed``; ``seed`` reorders them
    and relabels the items by two permutations, so every seed has the same
    lengths and the same repeats, in another order.

    Returns a dict: ``lengths`` (training lengths), ``items`` (the training
    items of all sequences, concatenated, ids numbered first seen from 1;
    0 is the pad id), ``test`` (each sequence's target, by the same ids, or
    -1 where the target never occurs in training), ``n_items`` (the
    training vocabulary)."""
    rng = np.random.default_rng(structure_seed)
    lens = np.clip(rng.lognormal(mean=np.log(mean_len), sigma=0.6, size=n_seqs),
                   3, 200).astype(np.int64)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    pop /= pop.sum()
    drawn = rng.choice(n_items, size=int((lens + 1).sum()), p=pop)
    relabel = np.random.default_rng(seed)
    order = relabel.permutation(n_seqs)
    drawn = relabel.permutation(n_items)[drawn]
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]])
    lens = lens[order]
    drawn = np.concatenate([drawn[starts[k]:starts[k] + n + 1] for k, n in zip(order, lens)])
    ends = np.cumsum(lens + 1)
    is_test = np.zeros(len(drawn), dtype=bool)
    is_test[ends - 1] = True
    train, test = drawn[~is_test], drawn[is_test]
    first = _first_seen(train)
    id_map = np.full(n_items, -1, dtype=np.int64)
    id_map[first] = np.arange(1, len(first) + 1)
    return {"lengths": lens, "items": id_map[train], "test": id_map[test],
            "n_items": len(first)}
