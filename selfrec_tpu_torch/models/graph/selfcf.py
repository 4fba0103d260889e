"""SelfCF, the history-embedding variant SelfCF-he (counterpart of
``selfrec_tpu/models/graph/selfcf.py``).

Capability parity with reference/model/graph/SelfCF.py: one online LightGCN
encoder with no dropout (SelfCF.py:6,59); the target view comes from
HISTORY buffers drawn standard normal at build (SelfCF.py:63-64). Per
batch, target = his[rows] * tau + online[rows] * (1 - tau) with no
gradient, then his[rows] takes the current online rows (SelfCF.py:69-79);
both happen inside :meth:`batch_loss_aux`, the reference's in-forward order.
Loss = (1 - mean cos(pred(u_online), i_target)) / 2 + (1 - mean
cos(pred(i_online), u_target)) / 2 over the valid rows (SelfCF.py:89-95).
Scoring concatenates as BUIR's does (SelfCF.py:45-50). On the dense block
each hop is one K1 launch forward and one backward.
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.convert import flatten_params
from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.models.graph.buir import set_valid_rows
from selfrec_tpu_torch.ops.graph import lightgcn_propagate
from selfrec_tpu_torch.ops.init import layer_params, linear_apply, torch_linear_params
from selfrec_tpu_torch.ops.losses import l2_normalize


class SelfCF(TorchGraphRecommender):
    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.momentum = float(args.get("tau", 0.05))
        self.n_layers = int(args.get("n_layer", 2))
        self.adj = self.make_adj()

    def init_params(self, generator):
        params = super().init_params(generator)
        params.update(flatten_params({"predictor": torch_linear_params(
            generator, self.emb_size, self.emb_size, device=self.device)}))
        return params

    def build(self):
        super().build()
        # history buffers, standard normal (SelfCF.py:63-64), drawn after the
        # params from the step generator
        self.aux = {
            "u_his": torch.randn((self.data.user_num, self.emb_size),
                                 generator=self.generator, device=self.device),
            "i_his": torch.randn((self.data.item_num, self.emb_size),
                                 generator=self.generator, device=self.device),
        }

    def epoch_setup(self, epoch):
        return self.aux

    def _propagate(self, params):
        ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        out = lightgcn_propagate(self.adj, ego, self.n_layers, include_layer0=True)
        return out[: self.data.user_num], out[self.data.user_num:]

    def compute_embeddings(self, params):
        u_online, i_online = self._propagate(params)
        pred = layer_params(params, "predictor")
        p_u = linear_apply(pred, u_online)
        p_i = linear_apply(pred, i_online)
        return torch.cat([p_u, u_online], dim=1), torch.cat([i_online, p_i], dim=1)

    def batch_loss_aux(self, params, batch, generator=None):
        aux = batch["aux"]
        m = self.momentum
        u, i = batch["u"], batch["i"]
        u_on_all, i_on_all = self._propagate(params)
        u_rows = u_on_all[u].detach()
        i_rows = i_on_all[i].detach()
        u_target = aux["u_his"][u] * m + u_rows * (1.0 - m)
        i_target = aux["i_his"][i] * m + i_rows * (1.0 - m)
        valid = batch["mask"].to(torch.bool)
        new_aux = {"u_his": set_valid_rows(aux["u_his"], u, u_rows, valid),
                   "i_his": set_valid_rows(aux["i_his"], i, i_rows, valid)}

        pred = layer_params(params, "predictor")
        u_online = linear_apply(pred, u_on_all[u])
        i_online = linear_apply(pred, i_on_all[i])
        cos_ui = torch.sum(l2_normalize(u_online) * l2_normalize(i_target), dim=-1)
        cos_iu = torch.sum(l2_normalize(i_online) * l2_normalize(u_target), dim=-1)
        mask = batch["mask"]
        denom = torch.clamp(torch.sum(mask), min=1.0)
        loss_ui = (1.0 - torch.sum(cos_ui * mask) / denom) / 2.0
        loss_iu = (1.0 - torch.sum(cos_iu * mask) / denom) / 2.0
        return loss_ui + loss_iu, new_aux

    def batch_loss(self, params, batch, generator=None):
        return self.batch_loss_aux(params, batch, generator)[0]
