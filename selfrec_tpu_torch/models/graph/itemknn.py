"""ItemKNN, the item-neighbourhood baseline (counterpart of
``selfrec_tpu/models/graph/itemknn.py``).

Capability parity with reference/model/graph/ItemKNN.py: shrunk cosine
item-item similarity over user sets (ItemKNN.py:14-30), the top-``topK``
positive neighbours of each item (ItemKNN.py:36-56), and scores
``sum_{i in rated(u)} sim(i, j) * r / (sum sim + 1e-8)`` (ItemKNN.py:58-81).

The same two builds as UserKNN (:mod:`selfrec_tpu_torch.ops.knn`) over the
item side (C = R^T R, the item-side CSC for the blocked fallback); the
positive top-k sims are kept as an edge-list ``NormAdj``, and a block's
scores are its users' dense rated rows propagated over it.
"""

from __future__ import annotations

import numpy as np
import torch

from selfrec_tpu_torch.models.base import GraphRecommender
from selfrec_tpu_torch.ops import knn, ranking
from selfrec_tpu_torch.ops.graph import NormAdj, spmm

BLOCK = 512


class ItemKNN(GraphRecommender):
    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        self.topk = int(conf["topK"])
        self.shrinkage = int(conf["shrinkage"])
        self.k_eff = min(self.topk, max(self.data.item_num - 1, 1))
        e_u = torch.as_tensor(self.data.edge_users, dtype=torch.int64, device=self.device)
        e_i = torch.as_tensor(self.data.edge_items, dtype=torch.int64, device=self.device)
        w = torch.ones(self.data.n_edges, dtype=torch.float32, device=self.device)
        # out[j] += x[u] (dst item, src user): C = R^T R blockwise
        self._adj_u2i = NormAdj(e_u, e_i, w, self.data.item_num)
        counts = np.bincount(self.data.edge_items, minlength=self.data.item_num)
        self._item_deg = torch.as_tensor(counts, dtype=torch.float32, device=self.device)
        # item-side CSC (offsets, users), the blocked build's rows
        order = np.argsort(self.data.edge_items, kind="stable")
        self._csc_users = self.data.edge_users[order].astype(np.int32)
        self._csc_offsets = np.zeros(self.data.item_num + 1, dtype=np.int64)
        np.cumsum(counts, out=self._csc_offsets[1:])
        self._sim_adj = None  # top-k item-similarity edges

    def train(self):
        n_i, k = self.data.item_num, self.k_eff
        res = knn.topk_shrunk_cosine(
            self.data.edge_items, self.data.edge_users, n_i, self.data.user_num,
            self._item_deg, self.shrinkage, k)
        sims, ids = res if res is not None else self._train_blocked()
        # sparse top-k similarity as edges: out[j] += sim(i, j) * x[i]
        src = torch.arange(n_i, device=self.device).repeat_interleave(k)
        dst, w = ids.reshape(-1).long(), sims.reshape(-1)
        keep = w > 0
        self._sim_adj = NormAdj(src[keep], dst[keep], w[keep], n_i)

    def _train_blocked(self):
        """Budget fallback: per-block edge-list build (itemknn.py:92-125)."""
        return knn.blocked_topk_shrunk_cosine(
            self._adj_u2i, self._csc_offsets, self._csc_users, self._item_deg,
            self.data.user_num, self.shrinkage, self.k_eff, BLOCK)

    def _score_block(self, uids: torch.Tensor) -> torch.Tensor:
        """(B, n_items) scores of a block of users (itemknn.py:133-141)."""
        r_rows = knn.dense_rows(self.data.rated_offsets, self.data.rated_items,
                                uids.cpu().numpy(), self.data.item_num, self.device)
        s = spmm(self._sim_adj, r_rows.T.contiguous()).T
        return torch.where(s > 0, s / (s + 1e-8), torch.zeros_like(s))

    @torch.no_grad()
    def test(self):
        return ranking.rec_list_from_score_fn(self.data, self._score_block, self.max_N,
                                              block_size=BLOCK, device=self.device)
