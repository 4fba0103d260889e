"""XSimGCL (counterpart of ``selfrec_tpu/models/graph/xsimgcl.py``).

Capability parity with reference/model/graph/XSimGCL.py: a SINGLE perturbed
propagation per step; the contrastive view is the layer-``l_star``
embedding against the final (mean of layers 1..K) embedding
(XSimGCL.py:86-101), InfoNCE at the config's tau (XSimGCL.py:45-50) over
the batch's distinct users and items. BPR and L2 run on the perturbed final
embeddings (the training forward IS the perturbed one, XSimGCL.py:29-31),
the L2 not divided by the batch size (XSimGCL.py:33); eval is the clean
pass (XSimGCL.py:40-41). On the dense int8 block each hop is one K1 launch
forward and one backward.
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops import losses
from selfrec_tpu_torch.ops.graph import lightgcn_propagate, perturbed_propagate
from selfrec_tpu_torch.ops.sampling import unique_with_mask


class XSimGCL(TorchGraphRecommender):
    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.cl_rate = float(args.get("lambda", 0.2))
        self.eps = float(args.get("eps", 0.2))
        self.temp = float(args.get("tau", 0.15))
        self.n_layers = int(args.get("n_layer", 2))
        self.layer_cl = int(args.get("l_star", 1))
        self.adj = self.make_adj()

    def _ego(self, params):
        return torch.cat([params["user_emb"], params["item_emb"]], dim=0)

    def compute_embeddings(self, params):
        out = lightgcn_propagate(self.adj, self._ego(params), self.n_layers,
                                 include_layer0=False)
        return out[: self.data.user_num], out[self.data.user_num:]

    def batch_loss(self, params, batch, generator=None, noise=None):
        """BPR + L2 + cl_rate * InfoNCE for one batch; ``noise`` (a list of
        n_layers (n, D) U[0,1) draws, see perturbed_propagate) replaces the
        generator's draws in tests."""
        final, cl_view = perturbed_propagate(
            self.adj, self._ego(params), self.n_layers, self.eps,
            generator=generator, cl_layer=self.layer_cl, noise=noise)
        nu = self.data.user_num
        user_all, item_all = final[:nu], final[nu:]
        u = user_all[batch["u"]]
        p = item_all[batch["i"]]
        n = item_all[batch["j"]]
        mask = batch["mask"]
        rec = losses.bpr_loss(u, p, n, mask=mask)
        reg = losses.l2_reg_loss(self.reg, u, p, mask=mask)

        valid = mask.to(torch.bool)
        neg1 = torch.full_like(batch["u"], -1)
        u_idx, u_mask = unique_with_mask(torch.where(valid, batch["u"], neg1),
                                         self.batch_size)
        i_idx, i_mask = unique_with_mask(torch.where(valid, batch["i"], neg1),
                                         self.batch_size)
        user_cl = losses.infonce(user_all[u_idx], cl_view[:nu][u_idx], self.temp,
                                 mask=u_mask)
        item_cl = losses.infonce(item_all[i_idx], cl_view[nu:][i_idx], self.temp,
                                 mask=i_mask)
        return rec + reg + self.cl_rate * (user_cl + item_cl)
