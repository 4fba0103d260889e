"""UserKNN, the user-neighbourhood baseline (counterpart of
``selfrec_tpu/models/graph/userknn.py``).

Capability parity with reference/model/graph/UserKNN.py: shrunk cosine
user-user similarity ``n_common/(n_common+shrinkage) * dot / (|u| |v| +
1e-8)`` (UserKNN.py:14-30), the top-``topK`` positive neighbours excluding
self (UserKNN.py:41-52), and scores ``sum_v sim * r / (sum_v sim + 1e-8)``
over the neighbours that rated an item (UserKNN.py:61-80).

The similarity build is :func:`selfrec_tpu_torch.ops.knn.topk_shrunk_cosine`
(blocked int8 R R^T with exact integer sums), or its blocked edge-list
fallback when the dense R exceeds ``SELFREC_TPU_DENSE_BUDGET_GB``. Scores
are an edge-list product of each block's scattered neighbour weights, and
``test()`` ranks them through the scatter-mask plan with ``lax.top_k``'s
tie order. No training, no stochasticity.
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.models.base import GraphRecommender
from selfrec_tpu_torch.ops import knn, ranking
from selfrec_tpu_torch.ops.graph import NormAdj, spmm

BLOCK = 512


class UserKNN(GraphRecommender):
    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        self.topk = int(conf["topK"])
        self.shrinkage = int(conf["shrinkage"])
        self.k_eff = min(self.topk, max(self.data.user_num - 1, 1))
        e_u = torch.as_tensor(self.data.edge_users, dtype=torch.int64, device=self.device)
        e_i = torch.as_tensor(self.data.edge_items, dtype=torch.int64, device=self.device)
        w = torch.ones(self.data.n_edges, dtype=torch.float32, device=self.device)
        # out[v] += x[i] (dst user, src item): C = R R^T blockwise
        self._adj_i2u = NormAdj(e_i, e_u, w, self.data.user_num)
        # out[i] += x[v] (dst item, src user): S = W^T R blockwise
        self._adj_u2i = NormAdj(e_u, e_i, w, self.data.item_num)
        self._degrees = torch.as_tensor(self.data.rated_counts(), dtype=torch.float32,
                                        device=self.device)
        self.neighbor_ids = None
        self.neighbor_sims = None

    def train(self):
        res = knn.topk_shrunk_cosine(
            self.data.edge_users, self.data.edge_items, self.data.user_num,
            self.data.item_num, self._degrees, self.shrinkage, self.k_eff)
        if res is None:
            res = self._train_blocked()
        self.neighbor_sims, self.neighbor_ids = res

    def _train_blocked(self):
        """Budget fallback: per-block edge-list build (userknn.py:79-117)."""
        return knn.blocked_topk_shrunk_cosine(
            self._adj_i2u, self.data.rated_offsets, self.data.rated_items,
            self._degrees, self.data.item_num, self.shrinkage, self.k_eff, BLOCK)

    def _score_block(self, uids: torch.Tensor) -> torch.Tensor:
        """(B, n_items) scores of a block of users (userknn.py:119-134): the
        neighbour sims scattered into a (n_users, B) weight block, summed
        over each item's raters, then ``s / (s + 1e-8)`` where positive."""
        b = uids.shape[0]
        w = torch.zeros((self.data.user_num, b), dtype=torch.float32, device=self.device)
        rows = self.neighbor_ids[uids].long()
        cols = torch.arange(b, device=self.device)[:, None].expand_as(rows)
        w.index_put_((rows.reshape(-1), cols.reshape(-1)),
                     self.neighbor_sims[uids].reshape(-1), accumulate=True)
        s = spmm(self._adj_u2i, w).T
        return torch.where(s > 0, s / (s + 1e-8), torch.zeros_like(s))

    @torch.no_grad()
    def test(self):
        return ranking.rec_list_from_score_fn(self.data, self._score_block, self.max_N,
                                              block_size=BLOCK, device=self.device)
