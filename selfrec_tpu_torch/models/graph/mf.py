"""Matrix Factorization with BPR (counterpart of
``selfrec_tpu/models/graph/mf.py``).

Capability parity with reference/model/graph/MF.py: raw user/item embedding
tables, no adjacency and no propagation, BPR + L2 over (u, pos, neg) divided
by the batch size (MF.py:21), Adam. Evaluates every fifth epoch.
"""

from __future__ import annotations

from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops import losses


class MF(TorchGraphRecommender):
    def should_evaluate(self, epoch):
        return epoch % 5 == 0  # reference cadence (MF.py:30, LightGCN.py:34)

    def compute_embeddings(self, params):
        # copies: Adam updates the tables in place, and the embeddings that
        # fast_evaluation ranks and save() keeps must not move with them
        return params["user_emb"].detach().clone(), params["item_emb"].detach().clone()

    def batch_loss(self, params, batch, generator=None):
        u = params["user_emb"][batch["u"]]
        p = params["item_emb"][batch["i"]]
        n = params["item_emb"][batch["j"]]
        mask = batch["mask"]
        rec = losses.bpr_loss(u, p, n, mask=mask)
        reg = losses.l2_reg_loss(self.reg, u, p, n, mask=mask) / self.batch_size
        return rec + reg
