"""MHCN, multi-channel hypergraph convolution over social motifs
(counterpart of ``selfrec_tpu/models/graph/mhcn.py``).

Capability parity with reference/model/graph/MHCN.py: three motif hypergraph
channels (H_s, H_j, H_p; :mod:`selfrec_tpu_torch.data.motifs`) and a simple
channel over R; each layer updates the item table from the attention-mixed
user channels through Rᵀ and the simple channel from R applied to the
PRE-update item table (MHCN.py:117-138); layer lists are summed, final
user = channel_attention(c1, c2, c3) + simple / 2 (MHCN.py:139-148);
hierarchical mutual-information self-supervision with row and row+column
shuffles as negatives (MHCN.py:159-181); loss = summed BPR + reg *
l2_loss(every gating and attention weight) + reg * l2_loss(batch
embeddings) + ss_rate * ss (MHCN.py:184-189).

Two arms, chosen as the JAX package chooses (mhcn.py:61-79): where
``dense_general_available`` allows a (U, U) block and the three channels
plus R and Rᵀ fit ``SELFREC_TPU_DENSE_BUDGET_GB`` together, the motifs are
built on the device and all five matrices are :class:`DenseMat` (GEMMs
with f32 sums, no kernel of the port); otherwise the scipy motifs and R
go to the ELL layout, where every product is one K2 launch forward and
one backward. Under a mesh ``shard_adj`` row-shards each DenseMat over
the grid (``ShardedDenseMat``) or makes each ELL layout a ``HaloAdj``
(mhcn.py:61-80).

The shuffles' permutations come from the step generator
(:meth:`MHCN.ss_permutations`) or are fed through ``batch_loss(...,
perms=...)``, so tests can hand both packages the same ones.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from selfrec_tpu_torch.data.graph import normalize_graph_mat
from selfrec_tpu_torch.data.motifs import mhcn_hypergraphs, mhcn_hypergraphs_device
from selfrec_tpu_torch.data.social import Relation
from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops import losses
from selfrec_tpu_torch.ops.graph import (dense_general_available, norm_adj_from_scipy,
                                         spmm)
from selfrec_tpu_torch.ops.init import xavier_uniform
from selfrec_tpu_torch.ops.losses import l2_loss, l2_normalize
from selfrec_tpu_torch.ops.spmm_dense import DenseMat, _generic_dtype, fits_dense_elems
from selfrec_tpu_torch.utils import trace

N_CHANNELS = 4


class MHCN(TorchGraphRecommender):
    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.n_layers = int(args.get("n_layer", 2))
        self.ss_rate = float(args.get("ss_rate", 0.01))
        with trace.span("setup.data"):
            self.social_data = Relation(conf, kwargs["social.data"], self.data.user)

        with trace.span("setup.adj"):
            nu, ni = self.data.user_num, self.data.item_num
            # the AGGREGATE resident set (three U x U channels, R and R^T) against
            # the budget, as the JAX package gates it
            dg = (dense_general_available(nu, nu, self.device)
                  and fits_dense_elems(3 * nu * nu + 2 * nu * ni, _generic_dtype()))
            social = self.social_data.get_social_mat()
            if dg:
                h_dense = mhcn_hypergraphs_device(social, self.data.interaction_mat,
                                                  self.device)
                self.H = []
                while h_dense:  # each f32 block freed once its copy is made
                    self.H.append(self.shard_adj(DenseMat(h_dense.pop(0).to(_generic_dtype()))))
            else:
                self.H = [self.shard_adj(norm_adj_from_scipy(h, device=self.device))
                          for h in mhcn_hypergraphs(social, self.data.interaction_mat)]
            r_norm = normalize_graph_mat(self.data.interaction_mat)  # D^-1 R
            self.R = self.shard_adj(norm_adj_from_scipy(r_norm, device=self.device,
                                                        dense_general=dg))
            self.Rt = self.shard_adj(norm_adj_from_scipy(r_norm.T.tocsr(), device=self.device,
                                                         dense_general=dg))

    def print_model_info(self):
        super().print_model_info()
        print("Social data size: (user number: %d, relation number: %d)."
              % self.social_data.size())
        print("=" * 80)

    def init_params(self, generator):
        d = self.emb_size

        def xavier(shape):
            return xavier_uniform(generator, shape, device=self.device)

        params = {
            "user_emb": xavier((self.data.user_num, d)),
            "item_emb": xavier((self.data.item_num, d)),
            "attention": xavier((1, d)),
            "attention_mat": xavier((d, d)),
        }
        for c in range(1, N_CHANNELS + 1):
            params[f"gating{c}"] = xavier((d, d))
            params[f"gating_bias{c}"] = xavier((1, d))
            params[f"sgating{c}"] = xavier((d, d))
            params[f"sgating_bias{c}"] = xavier((1, d))
        return params

    # -- forward --------------------------------------------------------------
    @staticmethod
    def _gate(em, w, b):
        return em * torch.sigmoid(em @ w + b)

    def _channel_attention(self, params, *channels):
        scores = torch.stack(
            [torch.sum(params["attention"] * (c @ params["attention_mat"]), dim=1)
             for c in channels], dim=1)  # (n_users, n_channels)
        score = torch.softmax(scores, dim=1)
        mixed = sum(score[:, i: i + 1] * c for i, c in enumerate(channels))
        return mixed, score

    def forward(self, params):
        def g(em, c):
            return self._gate(em, params[f"gating{c}"], params[f"gating_bias{c}"])

        user = params["user_emb"]
        c1, c2, c3 = g(user, 1), g(user, 2), g(user, 3)
        simple = g(user, 4)
        item_emb = params["item_emb"]
        all_c = [[c1], [c2], [c3]]
        all_simple = [simple]
        all_i = [item_emb]
        for _ in range(self.n_layers):
            mixed = self._channel_attention(params, c1, c2, c3)[0] + simple / 2
            c1 = spmm(self.H[0], c1)
            c2 = spmm(self.H[1], c2)
            c3 = spmm(self.H[2], c3)
            for lst, c in zip(all_c, (c1, c2, c3)):
                lst.append(l2_normalize(c))
            new_item = spmm(self.Rt, mixed)
            all_i.append(l2_normalize(new_item))
            simple = spmm(self.R, item_emb)  # the pre-update item table
            all_simple.append(l2_normalize(simple))
            item_emb = new_item
        c1s, c2s, c3s = (sum(lst) for lst in all_c)
        final_user, _ = self._channel_attention(params, c1s, c2s, c3s)
        return final_user + sum(all_simple) / 2, sum(all_i)

    def compute_embeddings(self, params):
        return self.forward(params)

    # -- hierarchical self-supervision ----------------------------------------
    def ss_permutations(self, generator) -> List[Sequence[torch.Tensor]]:
        """Per channel, the shuffles of :meth:`_hierarchical_ss` in the order
        it uses them: rows of em, rows then columns of the edge embeddings
        (local), rows then columns again (global)."""
        n, d = self.data.user_num, self.emb_size

        def perm(m):
            return torch.randperm(m, generator=generator, device=self.device)

        return [(perm(n), perm(n), perm(d), perm(n), perm(d)) for _ in range(3)]

    def _hierarchical_ss(self, em, adj, perms):
        p_row, p_local_row, p_local_col, p_global_row, p_global_col = perms

        def score(a, b):
            return torch.sum(a * b, dim=1)

        edge = spmm(adj, em)
        pos = score(em, edge)
        neg1 = score(em[p_row], edge)
        neg2 = score(edge[p_local_row][:, p_local_col], em)
        local = torch.sum(-torch.log(torch.sigmoid(pos - neg1))
                          - torch.log(torch.sigmoid(neg1 - neg2)))
        graph = torch.mean(edge, dim=0)
        pos_g = score(edge, graph[None, :])
        neg1_g = score(edge[p_global_row][:, p_global_col], graph[None, :])
        global_ = torch.sum(-torch.log(torch.sigmoid(pos_g - neg1_g)))
        return local + global_

    def batch_loss(self, params, batch, generator=None,
                   perms: Optional[List[Sequence[torch.Tensor]]] = None):
        final_user, final_item = self.forward(params)
        u = final_user[batch["u"]]
        p = final_item[batch["i"]]
        n = final_item[batch["j"]]
        mask = batch["mask"]
        rec = losses.bpr_loss_sum(u, p, n, mask=mask)

        reg = 0.0
        for c in range(1, N_CHANNELS + 1):
            for name in ("gating", "gating_bias", "sgating", "sgating_bias"):
                reg = reg + l2_loss(params[f"{name}{c}"])
        reg = reg + l2_loss(params["attention"]) + l2_loss(params["attention_mat"])
        m = mask[:, None]
        reg = reg + l2_loss(u * m) + l2_loss(p * m) + l2_loss(n * m)
        reg = self.reg * reg

        if perms is None:
            perms = self.ss_permutations(generator)

        def sg(em, c):
            return self._gate(em, params[f"sgating{c}"], params[f"sgating_bias{c}"])

        ss = sum(self._hierarchical_ss(sg(final_user, c + 1), self.H[c], perms[c])
                 for c in range(3))
        return rec + reg + self.ss_rate * ss
