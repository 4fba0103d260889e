"""LightGCN (counterpart of ``selfrec_tpu/models/graph/lightgcn.py``).

Capability parity with reference/model/graph/LightGCN.py: K-layer
propagation over the normalized bipartite adjacency with the mean over
layer outputs including layer 0 (LightGCN.py:68-78), BPR on the propagated
embeddings plus L2 on the EGO (table) rows of the batch, divided by the
batch size (LightGCN.py:25). On the ELL layout every hop is one K2 launch
forward and one backward (the transpose layout).
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops import losses
from selfrec_tpu_torch.ops.graph import lightgcn_propagate


class LightGCN(TorchGraphRecommender):
    def should_evaluate(self, epoch):
        return epoch % 5 == 0  # reference cadence (MF.py:30, LightGCN.py:34)

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.n_layers = int(args.get("n_layer", 2))
        self.adj = self.make_adj()

    def compute_embeddings(self, params):
        ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        out = lightgcn_propagate(self.adj, ego, self.n_layers, include_layer0=True)
        return out[: self.data.user_num], out[self.data.user_num:]

    def batch_loss(self, params, batch, generator=None):
        user_all, item_all = self.compute_embeddings(params)
        u = user_all[batch["u"]]
        p = item_all[batch["i"]]
        n = item_all[batch["j"]]
        mask = batch["mask"]
        rec = losses.bpr_loss(u, p, n, mask=mask)
        reg = losses.l2_reg_loss(
            self.reg, params["user_emb"][batch["u"]], params["item_emb"][batch["i"]],
            params["item_emb"][batch["j"]], mask=mask) / self.batch_size
        return rec + reg
