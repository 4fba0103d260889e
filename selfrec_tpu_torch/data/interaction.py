"""User-item interaction dataset.

Host-side, one-time preprocessing that converts raw string-keyed triples into
the integer/array form every on-device op consumes. Capability parity with the
reference ``Interaction`` (reference/data/ui_graph.py:8-122): same
first-seen id assignment, same test-set filtering to train-seen users/items
(ui_graph.py:42-45), same normalized symmetric bipartite adjacency
(ui_graph.py:47-56). Beyond the reference, it precomputes the device-ready
edge arrays and per-user sorted rated-item CSR used by the device samplers,
propagation and eval maskers — the reference's dict-of-dicts hot paths
(sampler.py:23-27, graph_recommender.py:44-51) do not exist here.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from selfrec_tpu_torch.data.graph import csr_to_edges, normalize_graph_mat


class Interaction:
    """``training_data`` is either a list of (user, item, weight) triples
    (reference-compatible path) or a :class:`MappedGraph`-style tuple
    ``(src_ids, dst_ids, weights, src_names, dst_names)`` from the native
    loader (array-native fast path — no per-triple Python loops)."""

    def __init__(self, conf, training_data, test_data):
        self.config = conf
        self.test_data = test_data

        self.user: Dict[str, int] = {}
        self.item: Dict[str, int] = {}
        self.id2user: Dict[int, str] = {}
        self.id2item: Dict[int, str] = {}
        self.test_set: Dict[str, Dict[str, float]] = defaultdict(dict)
        self.test_set_item = set()
        self._training_set_u = None
        self._training_set_i = None

        if isinstance(training_data, tuple) and len(training_data) == 5:
            src, dst, _w, src_names, dst_names = training_data
            self.training_data = training_data
            self.user = {n: i for i, n in enumerate(src_names)}
            self.item = {n: i for i, n in enumerate(dst_names)}
            self.id2user = dict(enumerate(src_names))
            self.id2item = dict(enumerate(dst_names))
            self.edge_users = np.asarray(src, dtype=np.int32)
            self.edge_items = np.asarray(dst, dtype=np.int32)
            self._n_training = len(self.edge_users)
            self._generate_test_set()
        else:
            self.training_data = training_data
            self._generate_set()
            self._n_training = len(training_data)
            self.edge_users = np.array(
                [self.user[u] for u, _, _ in training_data], dtype=np.int32
            )
            self.edge_items = np.array(
                [self.item[i] for _, i, _ in training_data], dtype=np.int32
            )

        self.user_num = len(self.user)
        self.item_num = len(self.item)
        self.n_edges = len(self.edge_users)

        # scipy matrices (host-side, setup only).
        self.interaction_mat = self._build_interaction_mat()
        self.ui_adj = self._build_bipartite_adj()
        self.norm_adj = normalize_graph_mat(self.ui_adj)

        # Device-ready normalized adjacency as (src, dst, w) sorted by dst.
        self.adj_src, self.adj_dst, self.adj_w = self._norm_adj_edges(self.norm_adj)

        # Per-user rated-item CSR with item ids sorted ascending within each
        # user: membership tests become binary searches on device.
        self.rated_offsets, self.rated_items = self._build_rated_csr()

        # Test users in reference iteration order (dict insertion order) and
        # their integer ids.
        self.test_users: List[str] = list(self.test_set.keys())
        self.test_user_ids = np.array(
            [self.user[u] for u in self.test_users], dtype=np.int32
        )

    def test_gt_csr(self):
        """(offsets, items) CSR of each test user's ground-truth item ids,
        rows in ``test_users`` order, items in INSERTION order (the NDCG
        IDCG quirk depends on it — util/evaluation.py:94-95). Cached; feeds
        the id-based eval fast path (utils/metrics.ranking_evaluation_ids)."""
        cached = getattr(self, "_test_gt_csr", None)
        if cached is None:
            offsets = np.zeros(len(self.test_users) + 1, dtype=np.int64)
            items: List[int] = []
            for r, u in enumerate(self.test_users):
                items.extend(self.item[i] for i in self.test_set[u])
                offsets[r + 1] = len(items)
            cached = self._test_gt_csr = (
                offsets, np.asarray(items, dtype=np.int32))
        return cached

    # -- construction -------------------------------------------------------
    def _generate_set(self) -> None:
        self._training_set_u = defaultdict(dict)
        self._training_set_i = defaultdict(dict)
        for user, item, _rating in self.training_data:
            if user not in self.user:
                uid = len(self.user)
                self.user[user] = uid
                self.id2user[uid] = user
            if item not in self.item:
                iid = len(self.item)
                self.item[item] = iid
                self.id2item[iid] = item
            self._training_set_u[user][item] = 1
            self._training_set_i[item][user] = 1
        self._generate_test_set()

    def _generate_test_set(self) -> None:
        for user, item, _rating in self.test_data:
            if user in self.user and item in self.item:
                self.test_set[user][item] = 1
                self.test_set_item.add(item)

    # Lazy dict-of-dicts views (the reference's primary data structure,
    # ui_graph.py:17-19). The array fast path never builds them unless the
    # legacy query surface is actually used.
    @property
    def training_set_u(self) -> Dict[str, Dict[str, float]]:
        if self._training_set_u is None:
            d: Dict[str, Dict[str, float]] = defaultdict(dict)
            for u, i in zip(self.edge_users, self.edge_items):
                d[self.id2user[int(u)]][self.id2item[int(i)]] = 1
            for uid in range(self.user_num):  # degree-0 users still present
                d.setdefault(self.id2user[uid], {})
            self._training_set_u = d
        return self._training_set_u

    @property
    def training_set_i(self) -> Dict[str, Dict[str, float]]:
        if self._training_set_i is None:
            d: Dict[str, Dict[str, float]] = defaultdict(dict)
            for u, i in zip(self.edge_users, self.edge_items):
                d[self.id2item[int(i)]][self.id2user[int(u)]] = 1
            for iid in range(self.item_num):
                d.setdefault(self.id2item[iid], {})
            self._training_set_i = d
        return self._training_set_i

    def _build_interaction_mat(self) -> sp.csr_matrix:
        vals = np.ones(self.n_edges, dtype=np.float32)
        return sp.csr_matrix(
            (vals, (self.edge_users, self.edge_items)),
            shape=(self.user_num, self.item_num),
            dtype=np.float32,
        )

    def _build_bipartite_adj(self, self_connection: bool = False) -> sp.csr_matrix:
        n = self.user_num + self.item_num
        vals = np.ones(self.n_edges, dtype=np.float32)
        upper = sp.csr_matrix(
            (vals, (self.edge_users, self.edge_items + self.user_num)),
            shape=(n, n),
            dtype=np.float32,
        )
        adj = upper + upper.T
        if self_connection:
            adj = adj + sp.eye(n, dtype=np.float32)
        return adj

    @staticmethod
    def _norm_adj_edges(norm_adj: sp.spmatrix):
        # norm_adj rows are destinations: out[d] = sum_s A[d, s] x[s].
        # Sorted by dst so segment reductions can assume sorted indices.
        dst, src, w = csr_to_edges(norm_adj, sort_by_row=True)
        return src, dst, w

    def convert_to_laplacian_mat(self, adj_mat: sp.spmatrix) -> sp.spmatrix:
        """Re-embed an n_u x n_i interaction matrix into the symmetric
        (n_u+n_i)^2 space and normalize. Reference: ui_graph.py:58-65.
        Used by edge/node-dropout augmentation (SGL)."""
        rows, cols = adj_mat.nonzero()
        vals = np.asarray(adj_mat.tocoo().data, dtype=np.float32)
        n = adj_mat.shape[0] + adj_mat.shape[1]
        upper = sp.csr_matrix(
            (vals, (rows, cols + adj_mat.shape[0])), shape=(n, n), dtype=np.float32
        )
        return normalize_graph_mat(upper + upper.T)

    def _build_rated_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        order = np.lexsort((self.edge_items, self.edge_users))
        sorted_users = self.edge_users[order]
        sorted_items = self.edge_items[order]
        counts = np.bincount(sorted_users, minlength=self.user_num)
        offsets = np.zeros(self.user_num + 1, dtype=np.int32)
        np.cumsum(counts, out=offsets[1:])
        return offsets, sorted_items.astype(np.int32)

    # -- reference-compatible query surface ----------------------------------
    def get_user_id(self, u: str):
        return self.user.get(u)

    def get_item_id(self, i: str):
        return self.item.get(i)

    def training_size(self) -> Tuple[int, int, int]:
        return len(self.user), len(self.item), self._n_training

    def test_size(self) -> Tuple[int, int, int]:
        return len(self.test_set), len(self.test_set_item), len(self.test_data)

    def contain(self, u: str, i: str) -> bool:
        return u in self.user and i in self.training_set_u[u]

    def contain_user(self, u: str) -> bool:
        return u in self.user

    def contain_item(self, i: str) -> bool:
        return i in self.item

    def user_rated(self, u: str):
        return list(self.training_set_u[u].keys()), list(self.training_set_u[u].values())

    def item_rated(self, i: str):
        return list(self.training_set_i[i].keys()), list(self.training_set_i[i].values())

    def row(self, u: int) -> np.ndarray:
        vec = np.zeros(self.item_num, dtype=np.float32)
        lo, hi = self.rated_offsets[u], self.rated_offsets[u + 1]
        vec[self.rated_items[lo:hi]] = 1.0
        return vec

    def col(self, i: int) -> np.ndarray:
        vec = np.zeros(self.user_num, dtype=np.float32)
        name = self.id2item[i]
        for user in self.training_set_i[name]:
            vec[self.user[user]] = 1.0
        return vec

    def matrix(self) -> np.ndarray:
        return np.asarray(self.interaction_mat.todense(), dtype=np.float32)

    # -- device-feed helpers -------------------------------------------------
    def rated_counts(self) -> np.ndarray:
        return np.diff(self.rated_offsets)

    def user_rated_ids(self, uid: int) -> np.ndarray:
        lo, hi = self.rated_offsets[uid], self.rated_offsets[uid + 1]
        return self.rated_items[lo:hi]
