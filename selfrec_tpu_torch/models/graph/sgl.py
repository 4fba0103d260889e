"""SGL, Self-supervised Graph Learning (counterpart of
``selfrec_tpu/models/graph/sgl.py``).

Capability parity with reference/model/graph/SGL.py: LightGCN propagation
(mean over layers INCLUDING layer 0, SGL.py:100-111), BPR + L2(u, pos, neg)
(not scaled by the batch size, SGL.py:36) + cl_rate x InfoNCE over the
concatenated [user; item] anchors of two views propagated through two
per-EPOCH dropped adjacencies (SGL.py:28-29, 115-127). ``aug_type`` 0 is
node dropout, 1 and 2 edge dropout; the reference's ``if self.aug_type==0
or 1`` (SGL.py:81) is always true, so aug_type 2 behaves as 1 here too.
fast_evaluation runs from epoch 5 on (SGL.py:44-45).

Keep masks are drawn on the host with the reference augmentor's exact
counts, from ``epoch_rng(epoch, stream=1)``: the JAX package draws the
same masks. Two arms, chosen by the adjacency's layout:

- ELL: the clean graph and both dropped views share one template layout
  and differ only in weights, so the three chains run as ONE packed
  width-3D chain, one K2 launch per hop forward and one backward. The
  chains' slot weights over both directions of the template are built
  once an epoch, with the views, and every step reads them as they are;
- dense: each view is a new int8-factored block per epoch
  (``DenseAdj.refactor_view``), propagated like the clean block (K1 in
  every matmul mode).

Under a mesh the dense views are refactored ``ShardedDenseAdj`` slices and
the ELL template is a ``HaloAdj`` reweighted per epoch.

Spans: the template's build is part of ``setup.adj`` (and counted as a
``layout.*``); each epoch's views are ``views.keep`` (the host draws and
their copy) and ``views.weights`` (the device work, also a device span
under a profiler; on the ELL template it also builds the epoch's slot
weights).
"""

from __future__ import annotations

import numpy as np
import torch

from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops import losses
from selfrec_tpu_torch.ops.graph import (bipartite_renorm_weights,
                                         build_bipartite_ell_template,
                                         lightgcn_propagate, spmm, spmm_packed)
from selfrec_tpu_torch.ops.sampling import unique_with_mask
from selfrec_tpu_torch.ops.spmm_dense import DenseAdj, adj_edge_perm
from selfrec_tpu_torch.ops.spmm_ell import EllAdj, packed_slot_weights
from selfrec_tpu_torch.parallel.dense_shard import ShardedDenseAdj
from selfrec_tpu_torch.utils import trace


class SGL(TorchGraphRecommender):
    def should_evaluate(self, epoch):
        return epoch >= 5  # reference cadence (SGL.py:44-45)

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.cl_rate = float(args.get("lambda", 0.1))
        self.aug_type = int(args.get("aug_type", 1))
        self.drop_rate = float(args.get("drop_rate", 0.1))
        self.n_layers = int(args.get("n_layer", 2))
        self.temp = float(args.get("temp", 0.2))
        self.adj = self.make_adj()
        self._edge_users_dev = torch.as_tensor(self.data.edge_users, device=self.device)
        self._edge_items_dev = torch.as_tensor(self.data.edge_items, device=self.device)
        self._view_template = None
        self._w_clean = None
        self._slots = None  # the ELL template's SlotWeights of the epoch
        self._view1 = None
        self._view2 = None
        with trace.span("setup.adj"):
            if isinstance(self.adj, (DenseAdj, ShardedDenseAdj)):
                # the block's edge order (scipy COO of norm_adj) differs from
                # the dataset's, in which the keep masks are drawn
                self._edge_perm = torch.as_tensor(
                    adj_edge_perm(self.adj, self.data.edge_users, self.data.edge_items,
                                  self.data.item_num), device=self.device).long()
            else:
                self._view_template = self.shard_adj(build_bipartite_ell_template(
                    self.data.edge_users, self.data.edge_items, self.data.user_num,
                    self.data.item_num, device=self.device))
                trace.count(f"layout.{type(self._view_template).__name__}")
                # clean-graph weights over the template (== norm_adj's)
                self._w_clean = bipartite_renorm_weights(
                    self._edge_users_dev, self._edge_items_dev,
                    torch.ones(self.data.n_edges, dtype=torch.bool, device=self.device),
                    self.data.user_num, self.data.item_num)

    def _ego(self, params):
        return torch.cat([params["user_emb"], params["item_emb"]], dim=0)

    def compute_embeddings(self, params):
        out = lightgcn_propagate(self.adj, self._ego(params), self.n_layers,
                                 include_layer0=True)
        return out[: self.data.user_num], out[self.data.user_num:]

    # -- per-epoch dropped views ----------------------------------------------
    def _edge_keep_mask(self, rng) -> np.ndarray:
        """Kept-edge indicator with the reference augmentor's exact counts
        (data/augmentor.py:11-40)."""
        n_e = self.data.n_edges
        keep = np.zeros(n_e, dtype=bool)
        if self.aug_type == 0:
            n_u, n_i = self.data.user_num, self.data.item_num
            drop_u = rng.choice(n_u, size=int(n_u * self.drop_rate), replace=False)
            drop_i = rng.choice(n_i, size=int(n_i * self.drop_rate), replace=False)
            keep_u = np.ones(n_u, dtype=bool)
            keep_i = np.ones(n_i, dtype=bool)
            keep_u[drop_u] = False
            keep_i[drop_i] = False
            keep = keep_u[self.data.edge_users] & keep_i[self.data.edge_items]
        else:
            kept = rng.choice(n_e, size=int(n_e * (1 - self.drop_rate)), replace=False)
            keep[kept] = True
        return keep

    def _keep(self, rng) -> torch.Tensor:
        return torch.as_tensor(self._edge_keep_mask(rng), device=self.device)

    def epoch_setup(self, epoch):
        """The epoch's two dropped views: their keep masks drawn on the host
        and copied over (span ``views.keep``), then their blocks or weights
        made on the device (span and device span ``views.weights``). On an
        ELL template that also builds the three chains' slot weights
        (``_slots``), which every step of the epoch reads."""
        rng = self.epoch_rng(epoch, stream=1)
        with trace.span("views.keep"):
            keep1, keep2 = self._keep(rng), self._keep(rng)
        with trace.span("views.weights"), trace.device_span("views.weights", self.device):
            if self._view_template is None:
                self._view1 = self.adj.refactor_view(keep1[self._edge_perm])
                self._view2 = self.adj.refactor_view(keep2[self._edge_perm])
                return {}
            aux = {"w1": self._view_weights(keep1), "w2": self._view_weights(keep2)}
            if isinstance(self._view_template, EllAdj):
                self._slots = packed_slot_weights(self._view_template, torch.stack(
                    [self._w_clean, aux["w1"], aux["w2"]]))
            return aux

    def _view_weights(self, keep):
        return bipartite_renorm_weights(self._edge_users_dev, self._edge_items_dev,
                                        keep, self.data.user_num, self.data.item_num)

    # -- loss -----------------------------------------------------------------
    def _propagated_views(self, params, aux):
        """(clean, view1, view2) propagated (n, D) embeddings."""
        ego = self._ego(params)
        if self._view_template is None:
            outs = []
            for adj in (self.adj, self._view1, self._view2):
                x = ego
                acc = ego  # include_layer0=True (SGL.py:100-111)
                for _ in range(self.n_layers):
                    x = spmm(adj, x)
                    acc = acc + x
                outs.append(acc / (self.n_layers + 1))
            return outs
        if isinstance(self._view_template, EllAdj):
            w = self._slots
        else:  # HaloAdj: the per-edge weights
            w = torch.stack([self._w_clean, aux["w1"], aux["w2"]])
        x = torch.cat([ego, ego, ego], dim=1)
        acc = x
        for _ in range(self.n_layers):
            x = spmm_packed(self._view_template, w, x, 3)
            acc = acc + x
        out = acc / (self.n_layers + 1)
        d = self.emb_size
        return out[:, :d], out[:, d: 2 * d], out[:, 2 * d:]

    def batch_loss(self, params, batch, generator=None):
        clean, view1, view2 = self._propagated_views(params, batch["aux"])
        nu = self.data.user_num
        user_all, item_all = clean[:nu], clean[nu:]
        u = user_all[batch["u"]]
        p = item_all[batch["i"]]
        n = item_all[batch["j"]]
        mask = batch["mask"]
        rec = losses.bpr_loss(u, p, n, mask=mask)
        reg = losses.l2_reg_loss(self.reg, u, p, n, mask=mask)

        valid = mask.to(torch.bool)
        neg1 = torch.full_like(batch["u"], -1)
        u_idx, u_mask = unique_with_mask(torch.where(valid, batch["u"], neg1),
                                         self.batch_size)
        i_idx, i_mask = unique_with_mask(torch.where(valid, batch["i"], neg1),
                                         self.batch_size)
        v1 = torch.cat([view1[:nu][u_idx], view1[nu:][i_idx]], dim=0)
        v2 = torch.cat([view2[:nu][u_idx], view2[nu:][i_idx]], dim=0)
        m = torch.cat([u_mask, i_mask], dim=0)
        cl = self.cl_rate * losses.infonce(v1, v2, self.temp, mask=m)
        return rec + reg + cl
