"""SimGCL (counterpart of ``selfrec_tpu/models/graph/simgcl.py``).

Capability parity with reference/model/graph/SimGCL.py: LightGCN-style
propagation averaging layers 1..K (layer 0 excluded, SimGCL.py:81-91), BPR on
the clean pass, plus ``cl_rate`` x InfoNCE between two noise-perturbed passes
at the hardcoded tau=0.2 (SimGCL.py:43-50). The L2 regularisation applies to
the PROPAGATED user/pos embeddings and is NOT divided by the batch size
(SimGCL.py:31). The three propagations run as one width-3D chain; CL anchors
are the batch's distinct users/items (torch.unique at SimGCL.py:44-45).
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops import losses
from selfrec_tpu_torch.ops.graph import fused_simgcl_propagate, lightgcn_propagate
from selfrec_tpu_torch.ops.sampling import unique_with_mask


class SimGCL(TorchGraphRecommender):
    cl_temp = 0.2  # hardcoded in reference SimGCL.py:48-49

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.cl_rate = float(args.get("lambda", 0.5))
        self.eps = float(args.get("eps", 0.1))
        self.n_layers = int(args.get("n_layer", 2))
        self.adj = self.make_adj()

    def _ego(self, params):
        return torch.cat([params["user_emb"], params["item_emb"]], dim=0)

    def compute_embeddings(self, params):
        out = lightgcn_propagate(self.adj, self._ego(params), self.n_layers,
                                 include_layer0=False)
        return out[: self.data.user_num], out[self.data.user_num:]

    def _cl_from_views(self, view1, view2, batch):
        nu = self.data.user_num
        valid = batch["mask"].to(torch.bool)
        neg1 = torch.full_like(batch["u"], -1)
        u_idx, u_mask = unique_with_mask(torch.where(valid, batch["u"], neg1),
                                         self.batch_size)
        i_idx, i_mask = unique_with_mask(torch.where(valid, batch["i"], neg1),
                                         self.batch_size)
        user_cl = losses.infonce(view1[:nu][u_idx], view2[:nu][u_idx],
                                 self.cl_temp, mask=u_mask)
        item_cl = losses.infonce(view1[nu:][i_idx], view2[nu:][i_idx],
                                 self.cl_temp, mask=i_mask)
        return user_cl + item_cl

    def batch_loss(self, params, batch, generator=None, noise=None):
        """BPR + L2 + cl_rate * InfoNCE for one batch; ``noise`` (see
        fused_simgcl_propagate) replaces the generator's draws in tests."""
        clean, view1, view2 = fused_simgcl_propagate(
            self.adj, self._ego(params), self.n_layers, self.eps,
            generator=generator, noise=noise)
        nu = self.data.user_num
        user_all, item_all = clean[:nu], clean[nu:]
        u = user_all[batch["u"]]
        p = item_all[batch["i"]]
        n = item_all[batch["j"]]
        mask = batch["mask"]
        rec = losses.bpr_loss(u, p, n, mask=mask)
        reg = losses.l2_reg_loss(self.reg, u, p, mask=mask)
        cl = self.cl_rate * self._cl_from_views(view1, view2, batch)
        return rec + reg + cl
