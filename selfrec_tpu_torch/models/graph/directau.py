"""DirectAU (counterpart of ``selfrec_tpu/models/graph/directau.py``).

Capability parity with reference/model/graph/DirectAU.py: a LightGCN
encoder with layer 0 included (DirectAU.py:15), loss = alignment(u, pos) +
gamma * (uniformity(u) + uniformity(pos)) / 2 + l2(u, pos) / batch_size
(DirectAU.py:25, 37-48). Pad rows are masked out of both terms, as the
reference's exact-size ``torch.pdist`` has none (directau.py:49-54). Like
the JAX package, the trainer draws negatives and the loss ignores them.
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops import losses
from selfrec_tpu_torch.ops.graph import lightgcn_propagate


class DirectAU(TorchGraphRecommender):
    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.gamma = float(args.get("gamma", 2))
        self.n_layers = int(args.get("n_layers", 3))
        self.adj = self.make_adj()

    def compute_embeddings(self, params):
        ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        out = lightgcn_propagate(self.adj, ego, self.n_layers, include_layer0=True)
        return out[: self.data.user_num], out[self.data.user_num:]

    def batch_loss(self, params, batch, generator=None):
        user_all, item_all = self.compute_embeddings(params)
        u = user_all[batch["u"]]
        p = item_all[batch["i"]]
        mask = batch["mask"]
        align = losses.alignment_loss_masked(u, p, mask)
        uniform = 0.5 * self.gamma * (losses.uniformity_loss_masked(u, mask)
                                      + losses.uniformity_loss_masked(p, mask))
        reg = losses.l2_reg_loss(self.reg, u, p, mask=mask) / self.batch_size
        return align + uniform + reg
