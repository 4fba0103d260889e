"""NCL, neighborhood-enriched contrastive learning (counterpart of
``selfrec_tpu/models/graph/ncl.py``).

Capability parity with reference/model/graph/NCL.py: the LightGCN backbone
returning the per-layer embeddings (NCL.py:151-161); a structural loss that
contrasts each batch node's layer-(2 * hyper_layers) embedding with its
layer-0 embedding against ALL users (resp. items) as denominators, summed
(not averaged) and scaled by ssl_reg, the items' side also by alpha
(NCL.py:57-83); after 20 warm-up epochs, a prototype loss that contrasts
layer-0 embeddings with their k-means centroid at tau, scaled by proto_reg *
batch_size (NCL.py:29-55), the centroids recomputed on the RAW tables every
epoch (NCL.py:89-102) by :func:`selfrec_tpu_torch.ops.kmeans.kmeans`. Rec
loss = BPR + l2(u, p, n) / batch_size. On the dense int8 block each hop is
one K1 launch forward and one backward.

The E-step draws its initial centroids from the step generator, users'
first, then items'.
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops import losses
from selfrec_tpu_torch.ops.graph import lightgcn_propagate
from selfrec_tpu_torch.ops.kmeans import kmeans


class NCL(TorchGraphRecommender):
    warm_up_epochs = 20  # hardcoded in reference NCL.py:89,102

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.n_layers = int(args.get("n_layer", 3))
        self.ssl_temp = float(args.get("tau", 0.05))
        self.ssl_reg = float(args.get("ssl_reg", 1e-6))
        self.hyper_layers = int(args.get("hyper_layers", 1))
        self.alpha = float(args.get("alpha", 1.5))
        self.proto_reg = float(args.get("proto_reg", 1e-7))
        self.k = int(args.get("num_clusters", 2000))
        self.adj = self.make_adj()
        self._proto_phase = False

    def _propagate(self, params):
        ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        return lightgcn_propagate(self.adj, ego, self.n_layers, include_layer0=True,
                                  return_layers=True)

    def compute_embeddings(self, params):
        out, _ = self._propagate(params)
        return out[: self.data.user_num], out[self.data.user_num:]

    # -- phases ---------------------------------------------------------------
    def run_epoch(self, epoch):
        self._proto_phase = epoch >= self.warm_up_epochs
        return super().run_epoch(epoch)

    def epoch_setup(self, epoch):
        if not self._proto_phase:
            return {}
        # E-step on the raw embedding tables each epoch (NCL.py:29-44)
        with torch.no_grad():
            params = self.full_params()
            uc, u2c = kmeans(params["user_emb"].detach(), self.k,
                             generator=self.generator)
            ic, i2c = kmeans(params["item_emb"].detach(), self.k,
                             generator=self.generator)
        return {"user_cent": uc, "user2c": u2c, "item_cent": ic, "item2c": i2c}

    # -- losses ---------------------------------------------------------------
    def _ssl_layer_loss(self, context, initial, batch):
        nu = self.data.user_num
        mask = batch["mask"]

        def one_side(ctx_all, init_all, idx):
            ctx = losses.l2_normalize(ctx_all[idx])
            ini = losses.l2_normalize(init_all[idx])
            all_n = losses.l2_normalize(init_all)
            pos = torch.exp(torch.sum(ctx * ini, dim=1) / self.ssl_temp)
            ttl = torch.sum(torch.exp(ctx @ all_n.T / self.ssl_temp), dim=1)
            return torch.sum(-torch.log(pos / ttl) * mask)

        u_loss = one_side(context[:nu], initial[:nu], batch["u"])
        i_loss = one_side(context[nu:], initial[nu:], batch["i"])
        return self.ssl_reg * (u_loss + self.alpha * i_loss)

    def _proto_loss(self, initial, batch, aux):
        nu = self.data.user_num
        mask = batch["mask"]
        u_cent = aux["user_cent"][aux["user2c"][batch["u"]].long()]
        i_cent = aux["item_cent"][aux["item2c"][batch["i"]].long()]
        pl_u = losses.infonce(initial[:nu][batch["u"]], u_cent, self.ssl_temp,
                              mask=mask) * self.batch_size
        pl_i = losses.infonce(initial[nu:][batch["i"]], i_cent, self.ssl_temp,
                              mask=mask) * self.batch_size
        return self.proto_reg * (pl_u + pl_i)

    def batch_loss(self, params, batch, generator=None):
        out, emb_list = self._propagate(params)
        nu = self.data.user_num
        user_all, item_all = out[:nu], out[nu:]
        u = user_all[batch["u"]]
        p = item_all[batch["i"]]
        n = item_all[batch["j"]]
        mask = batch["mask"]
        rec = losses.bpr_loss(u, p, n, mask=mask)
        reg = losses.l2_reg_loss(self.reg, u, p, n, mask=mask) / self.batch_size
        initial = emb_list[0]
        context = emb_list[self.hyper_layers * 2]
        total = rec + reg + self._ssl_layer_loss(context, initial, batch)
        if self._proto_phase:
            total = total + self._proto_loss(initial, batch, batch["aux"])
        return total
