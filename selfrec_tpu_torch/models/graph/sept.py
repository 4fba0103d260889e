"""SEPT, socially-aware self-supervised tri-training (counterpart of
``selfrec_tpu/models/graph/sept.py``).

Capability parity with reference/model/graph/SEPT.py: three user views,
rec (the bipartite norm_adj), friend ((S·S)⊙S + I) and sharing ((Y·Yᵀ)⊙S
+ I), S being the reference's ``S.multiply(S)`` (the data/social.py
quirk), each encoded as a sum of l2-normalized LightGCN hops
(SEPT.py:48-64); an edge-dropped bipartite view rebuilt once per epoch
(SEPT.py:161-167); for the batch's unique users each view predicts a label
distribution over the dropped view (softmax of cosine logits,
SEPT.py:100-110), the other two views' averaged distributions vote the
top-``ins_cnt`` pseudo-positives (SEPT.py:112-116), and a neighbour
discrimination InfoNCE at tau 0.1 pulls each view toward them
(SEPT.py:118-134). The first third of training optimizes the rec loss
alone; the joint phase runs a FRESH Adam over rec + ss_rate *
discrimination (SEPT.py:137-159). Rec loss = summed BPR + reg *
l2_loss(the full tables) (SEPT.py:139-140).

Two arms, as in the JAX package (sept.py:73-131):
- dense: the social views are :class:`DenseMat` blocks built on the device,
  the rec chain runs on the dense bipartite block and the epoch's dropped
  view is a fresh factored block (``DenseAdj.refactor_view``), so in the
  int8x8 mode each hop is one K1 int8 launch forward and one backward;
- ELL: the rec and dropped views share the bipartite template's layout,
  and the social and sharing views the union layout of
  :func:`union_ell_template`, so each pair is one K2 chain at P = 2.

Under a mesh every layout goes through ``shard_adj`` (sept.py:91-104): the
social blocks to ``ShardedDenseMat``, the bipartite block to
``ShardedDenseAdj`` (its dropped view refactored), the templates to
``HaloAdj``.

Pseudo-positives are ranked with ``ranking.topk_lowest_index``: the masked
columns tie at exactly 0, and ``lax.top_k`` breaks ties by the lowest
index, which ``torch.topk`` does not promise.
"""

from __future__ import annotations

import numpy as np
import torch

from selfrec_tpu_torch.data.motifs import sept_views, sept_views_device
from selfrec_tpu_torch.data.social import Relation
from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops import losses
from selfrec_tpu_torch.ops.graph import (bipartite_renorm_weights,
                                         build_bipartite_ell_template,
                                         dense_general_available, spmm, spmm_packed,
                                         union_ell_template)
from selfrec_tpu_torch.ops.losses import l2_normalize
from selfrec_tpu_torch.ops.ranking import topk_lowest_index
from selfrec_tpu_torch.ops.sampling import unique_with_mask
from selfrec_tpu_torch.ops.spmm_dense import (DenseAdj, DenseMat, _generic_dtype,
                                              adj_edge_perm, fits_dense_elems)
from selfrec_tpu_torch.parallel.dense_shard import ShardedDenseAdj

SS_TEMP = 0.1  # hardcoded in reference SEPT.py:130-131


class SEPT(TorchGraphRecommender):
    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.n_layers = int(args.get("n_layer", 2))
        self.ss_rate = float(args.get("ss_rate", 0.005))
        self.drop_rate = float(args.get("drop_rate", 0.3))
        self.instance_cnt = int(args.get("ins_cnt", 10))
        self.social_data = Relation(conf, kwargs["social.data"], self.data.user)

        self.adj = self.make_adj()
        self._edge_users_dev = torch.as_tensor(self.data.edge_users, device=self.device)
        self._edge_items_dev = torch.as_tensor(self.data.edge_items, device=self.device)
        self._social_template = self._social_w_stack = None
        self._view_template = self._w_rec = None
        self._social_d1 = self._social_d2 = self._aug_view = None

        nu = self.data.user_num
        bi_social = self.social_data.get_birectional_social_mat()
        # both resident U x U views against the budget together
        if (dense_general_available(nu, nu, self.device)
                and fits_dense_elems(2 * nu * nu, _generic_dtype())):
            v1, v2 = sept_views_device(bi_social, self.data.interaction_mat, nu,
                                       self.device)
            self._social_d1 = self.shard_adj(DenseMat(v1.to(_generic_dtype())))
            del v1
            self._social_d2 = self.shard_adj(DenseMat(v2.to(_generic_dtype())))
            del v2
        else:
            views = sept_views(bi_social, self.data.interaction_mat, nu)
            template, self._social_w_stack = union_ell_template(list(views),
                                                                device=self.device)
            self._social_template = self.shard_adj(template)

        if self._dense_views():
            # the block's edge order (scipy COO of norm_adj) differs from the
            # dataset's, in which the keep mask is drawn
            self._edge_perm = torch.as_tensor(
                adj_edge_perm(self.adj, self.data.edge_users, self.data.edge_items,
                              self.data.item_num), device=self.device).long()
        else:
            self._view_template = self.shard_adj(build_bipartite_ell_template(
                self.data.edge_users, self.data.edge_items, nu, self.data.item_num,
                device=self.device))
            # clean-graph weights over the template (== norm_adj's), so the
            # rec chain shares the template's layout with the dropped view
            self._w_rec = bipartite_renorm_weights(
                self._edge_users_dev, self._edge_items_dev,
                torch.ones(self.data.n_edges, dtype=torch.bool, device=self.device),
                nu, self.data.item_num)
        self._joint_phase = False

    def _dense_views(self) -> bool:
        return isinstance(self.adj, (DenseAdj, ShardedDenseAdj))

    def print_model_info(self):
        super().print_model_info()
        print("Social data size: (user number: %d, relation number: %d)."
              % self.social_data.size())
        print("=" * 80)

    # -- encoders (sum of l2-normalized hops, SEPT.py:48-64) -------------------
    def _encode(self, adj, emb):
        total = emb
        e = emb
        for _ in range(self.n_layers):
            e = l2_normalize(spmm(adj, e))
            total = total + e
        return total

    def _encode_packed(self, template, w_stack, embs):
        """P encodes sharing one ELL layout as one width-P*D chain; exactly
        :meth:`_encode` per slice (each hop's l2_normalize is per slice)."""
        p = len(embs)
        d = embs[0].shape[1]
        x = torch.cat(embs, dim=1)
        total = x
        for _ in range(self.n_layers):
            x = spmm_packed(template, w_stack, x, p)
            x = torch.cat([l2_normalize(x[:, i * d: (i + 1) * d]) for i in range(p)],
                          dim=1)
            total = total + x
        return [total[:, i * d: (i + 1) * d] for i in range(p)]

    def _rec_embeddings(self, params):
        ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        out = self._encode(self.adj, ego)
        return out[: self.data.user_num], out[self.data.user_num:]

    def compute_embeddings(self, params):
        return self._rec_embeddings(params)

    # -- phases ---------------------------------------------------------------
    def enter_phase(self, epoch: int):
        """The warm or joint phase of ``epoch`` (joint once epoch >
        max_epoch / 3, reference SEPT.py:159). The joint phase runs its own
        fresh Adam (v2_opt, SEPT.py:150-153), made only at the warm-to-joint
        boundary: a checkpoint resumed inside the joint phase keeps its
        restored moments."""
        joint = epoch > self.max_epoch / 3
        if joint != self._joint_phase:
            self._joint_phase = joint
            if joint and not (epoch - 1) > self.max_epoch / 3:
                self.optimizer = self.make_optimizer(self.params)

    def run_epoch(self, epoch):
        self.enter_phase(epoch)
        return super().run_epoch(epoch)

    def epoch_setup(self, epoch):
        if not self._joint_phase:
            return {}
        n_e = self.data.n_edges
        keep_np = np.zeros(n_e, dtype=bool)
        keep_np[self.epoch_rng(epoch, stream=1).choice(
            n_e, size=int(n_e * (1 - self.drop_rate)), replace=False)] = True
        keep = torch.as_tensor(keep_np, device=self.device)
        if self._dense_views():
            # a fresh factored dropped view, kept on the model
            self._aug_view = self.adj.refactor_view(keep[self._edge_perm])
            return {}
        return {"aug_w": bipartite_renorm_weights(
            self._edge_users_dev, self._edge_items_dev, keep, self.data.user_num,
            self.data.item_num)}

    # -- tri-training ---------------------------------------------------------
    def _label_prediction(self, view_emb, aug_emb, col_mask):
        """softmax(norm(view) @ norm(aug)ᵀ) with the invalid columns masked."""
        logits = l2_normalize(view_emb) @ l2_normalize(aug_emb).T
        logits = torch.where(col_mask[None, :], logits, torch.full_like(logits, -1e9))
        return torch.softmax(logits, dim=1)

    def _neighbor_discrimination(self, pos_idx, view_emb, aug_emb, valid):
        emb = l2_normalize(view_emb)
        aug = l2_normalize(aug_emb)
        pos_emb = aug[pos_idx]  # (U, k, D)
        pos = torch.sum(emb[:, None, :] * pos_emb, dim=2)
        pos_score = torch.sum(torch.exp(pos / SS_TEMP), dim=1)
        ttl = torch.exp(emb @ aug.T / SS_TEMP)
        ttl = torch.where(valid[None, :], ttl, torch.zeros_like(ttl))
        ttl_score = torch.sum(ttl, dim=1)
        per = -torch.log(pos_score / torch.clamp(ttl_score, min=1e-12))
        return torch.sum(torch.where(valid, per, torch.zeros_like(per)))

    def _pseudo_positives(self, probs):
        """Each view's top-``ins_cnt`` columns by the other two views' mean
        label distribution (SEPT.py:112-116), ties to the lowest index as
        ``lax.top_k`` breaks them: the masked columns tie at exactly 0
        whenever fewer than ``ins_cnt`` are valid."""
        def top(pr):
            return topk_lowest_index(pr.detach(), self.instance_cnt)[1]

        return (top((probs["sharing"] + probs["rec"]) / 2),
                top((probs["friend"] + probs["rec"]) / 2),
                top((probs["friend"] + probs["sharing"]) / 2))

    def _rec_loss(self, params, rec_user, rec_item, batch):
        u = rec_user[batch["u"]]
        p = rec_item[batch["i"]]
        n = rec_item[batch["j"]]
        rec = losses.bpr_loss_sum(u, p, n, mask=batch["mask"])
        return rec + self.reg * (losses.l2_loss(params["user_emb"])
                                 + losses.l2_loss(params["item_emb"]))

    def batch_loss(self, params, batch, generator=None):
        if not self._joint_phase:
            rec_user, rec_item = self._rec_embeddings(params)
            return self._rec_loss(params, rec_user, rec_item, batch)

        # the joint phase's four chains (rec, dropped, friend, sharing) as two
        # packed ELL chains, or four dense ones (sept.py:253-277)
        mask = batch["mask"]
        ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        if self._dense_views():
            rec_all = self._encode(self.adj, ego)
            aug_all = self._encode(self._aug_view, ego)
        else:
            w_stack = torch.stack([self._w_rec, batch["aux"]["aug_w"]])
            rec_all, aug_all = self._encode_packed(self._view_template, w_stack,
                                                   [ego, ego])
        nu = self.data.user_num
        rec_user, rec_item = rec_all[:nu], rec_all[nu:]
        rec = self._rec_loss(params, rec_user, rec_item, batch)
        aug_user = aug_all[:nu]
        if self._social_d1 is not None:
            friend = self._encode(self._social_d1, params["user_emb"])
            sharing = self._encode(self._social_d2, params["user_emb"])
        else:
            friend, sharing = self._encode_packed(
                self._social_template, self._social_w_stack,
                [params["user_emb"], params["user_emb"]])

        valid_rows = mask.to(torch.bool)
        uniq, uniq_mask = unique_with_mask(
            torch.where(valid_rows, batch["u"], torch.full_like(batch["u"], -1)),
            self.batch_size)
        aug_u = aug_user[uniq]
        views = {"friend": friend[uniq], "sharing": sharing[uniq], "rec": rec_user[uniq]}
        probs = {k: self._label_prediction(v, aug_u, uniq_mask) for k, v in views.items()}
        f_pos, sh_pos, r_pos = self._pseudo_positives(probs)
        ss = (self._neighbor_discrimination(f_pos, views["friend"], aug_u, uniq_mask)
              + self._neighbor_discrimination(sh_pos, views["sharing"], aug_u, uniq_mask)
              + self._neighbor_discrimination(r_pos, views["rec"], aug_u, uniq_mask))
        return rec + self.ss_rate * ss
