"""BUIR, bootstrapped user/item representations with no negatives
(counterpart of ``selfrec_tpu/models/graph/buir.py``).

Capability parity with reference/model/graph/BUIR.py: online and target
LightGCN encoders, each forward over its own sparse adjacency dropout at a
random rate U[0,1) * drop_rate (BUIR.py:118-135), a linear predictor on the
online side, and the loss mean(2 - 2 cos(pred(online_u), target_i)) plus the
same from the items' side (BUIR.py:87-95). The target tables are ``aux``:
they start as copies of the online tables, take no gradient, and after each
Adam step only the batch's valid rows move toward the online tables by
momentum ``tau`` (BUIR.py:69-75). Scoring concatenates [pred(u); u] against
[i; pred(i)], so one matmul gives score_ui + score_iu (BUIR.py:46-51).

Layouts: on the dense block each view is a :meth:`DenseAdj.dropout_view`
(K1 in the block's matmul mode: online 2 hops forward and 2 backward,
target 2 forward, a step at n_layer 2); on ELL both chains share the layout
and run as one packed width-2D chain, one K2 launch at P = 2 per hop
forward and one backward (buir.py:97-119).

Draw order on ``generator``, the JAX package's key order (``split(key)``
into k_on, k_tg, each split into k_rate, k_keep): after the trainer's
negatives, the online view's rate (one ``torch.rand(())``) and keep draw
(E uniforms ``>= rate``), then the target view's.
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.convert import flatten_params
from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops.graph import (adj_dropout, lightgcn_propagate, spmm_packed,
                                         supports_packed)
from selfrec_tpu_torch.ops.init import layer_params, linear_apply, torch_linear_params
from selfrec_tpu_torch.ops.losses import l2_normalize


def set_valid_rows(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` with ``rows`` written at ``idx``: the JAX
    package's ``table.at[where(valid, idx, -1)].set(rows, mode="drop")``
    (buir.py:144-154, selfcf.py:78-84), quirk included. ``mode="drop"``
    drops only indices past the end; -1 is normalized to the last row, so
    each padded lane writes its row into the table's last row, and a later
    lane wins where lanes share a row (XLA's and torch's CPU scatter both
    apply updates in lane order; on the card the order is unspecified)."""
    out = table.clone()
    last = torch.full_like(idx, table.shape[0] - 1)
    out.index_put_((torch.where(valid, idx, last),), rows)
    return out


class BUIR(TorchGraphRecommender):
    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.momentum = float(args.get("tau", 0.995))
        self.n_layers = int(args.get("n_layer", 2))
        self.drop_rate = float(args.get("drop_rate", 0.2))
        if self.mesh is None:
            self.adj = self.make_adj()
        else:
            # the sharded dense block has no per-step dropout (graph.adj_dropout):
            # ELL, as a halo layout, under a mesh (buir.py:38-46)
            from selfrec_tpu_torch.ops.graph import norm_adj_from_scipy

            self.adj = self.shard_adj(norm_adj_from_scipy(self.data.norm_adj,
                                                          device=self.device))

    def init_params(self, generator):
        params = super().init_params(generator)
        params.update(flatten_params({"predictor": torch_linear_params(
            generator, self.emb_size, self.emb_size, device=self.device)}))
        return params

    def build(self):
        super().build()
        # the target tables start as copies of the online tables (BUIR.py:66-68)
        params = self.full_params()
        self.aux = {"t_user": params["user_emb"].detach().clone(),
                    "t_item": params["item_emb"].detach().clone()}

    def epoch_setup(self, epoch):
        return self.aux  # the target state persists across epochs

    def draw(self, generator):
        """This step's (rate, keep) for the online, then the target view,
        in the JAX package's key order; keep is over the adjacency's edges."""
        dev = self.adj.edge_w.device
        views = []
        for _ in range(2):
            rate = torch.rand((), generator=generator, device=dev) * self.drop_rate
            keep = torch.rand(self.adj.edge_w.shape, generator=generator, device=dev) >= rate
            views.append((rate, keep))
        return views

    def _propagate(self, user_table, item_table, view=None):
        ego = torch.cat([user_table, item_table], dim=0)
        adj = self.adj if view is None else adj_dropout(self.adj, view[0], keep=view[1])
        out = lightgcn_propagate(adj, ego, self.n_layers, include_layer0=True)
        return out[: self.data.user_num], out[self.data.user_num:]

    def compute_embeddings(self, params):
        u_online, i_online = self._propagate(params["user_emb"], params["item_emb"])
        pred = layer_params(params, "predictor")
        p_u = linear_apply(pred, u_online)
        p_i = linear_apply(pred, i_online)
        # [p_u ; u] @ [i ; p_i]^T == score_ui + score_iu (BUIR.py:46-51)
        return torch.cat([p_u, u_online], dim=1), torch.cat([i_online, p_i], dim=1)

    def _packed_chains(self, params, t_user, t_item, views):
        """Online and target chains as one width-2D chain over the shared
        ELL layout, each pass with its own dropped weights."""
        ew = self.adj.edge_w
        w_stack = torch.stack([torch.where(keep, ew / (1.0 - rate), torch.zeros_like(ew))
                               for rate, keep in views])
        on_ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        tg_ego = torch.cat([t_user, t_item], dim=0)
        x = torch.cat([on_ego, tg_ego], dim=1)
        acc = x  # include_layer0 (BUIR.py:137-141)
        for _ in range(self.n_layers):
            x = spmm_packed(self.adj, w_stack, x, 2)
            acc = acc + x
        out = acc / (self.n_layers + 1)
        d, nu = self.emb_size, self.data.user_num
        return out[:nu, :d], out[nu:, :d], out[:nu, d:], out[nu:, d:]

    def batch_loss(self, params, batch, generator=None, views=None):
        """mean over valid rows of (2 - 2 cos) both ways; ``views`` (see
        :meth:`draw`) replaces the generator's draws in tests."""
        if views is None:
            views = self.draw(generator)
        t_user = batch["aux"]["t_user"].detach()
        t_item = batch["aux"]["t_item"].detach()
        if supports_packed(self.adj):
            u_on_all, i_on_all, u_tg_all, i_tg_all = self._packed_chains(
                params, t_user, t_item, views)
        else:
            u_on_all, i_on_all = self._propagate(params["user_emb"], params["item_emb"],
                                                 views[0])
            with torch.no_grad():
                u_tg_all, i_tg_all = self._propagate(t_user, t_item, views[1])
        pred = layer_params(params, "predictor")
        u_online = l2_normalize(linear_apply(pred, u_on_all[batch["u"]]))
        i_online = l2_normalize(linear_apply(pred, i_on_all[batch["i"]]))
        u_target = l2_normalize(u_tg_all[batch["u"]].detach())
        i_target = l2_normalize(i_tg_all[batch["i"]].detach())
        loss_ui = 2.0 - 2.0 * torch.sum(u_online * i_target, dim=-1)
        loss_iu = 2.0 - 2.0 * torch.sum(i_online * u_target, dim=-1)
        m = batch["mask"]
        return torch.sum((loss_ui + loss_iu) * m) / torch.clamp(torch.sum(m), min=1.0)

    def step_update(self, params, aux, batch):
        """Momentum update of the batch's valid target rows only
        (BUIR.py:69-75)."""
        params = self.gather_leaves(params)
        m = self.momentum
        valid = batch["mask"].to(torch.bool)
        u, i = batch["u"], batch["i"]
        new_u = aux["t_user"][u] * m + params["user_emb"][u].detach() * (1 - m)
        new_i = aux["t_item"][i] * m + params["item_emb"][i].detach() * (1 - m)
        return {"t_user": set_valid_rows(aux["t_user"], u, new_u, valid),
                "t_item": set_valid_rows(aux["t_item"], i, new_i, valid)}
