"""MixGCF, hard-negative synthesis by positive mixing (counterpart of
``selfrec_tpu/models/graph/mixgcf.py``).

Capability parity with reference/model/graph/MixGCF.py: a LightGCN backbone
whose training forward applies elementwise dropout(0.1) after each hop
(MixGCF.py:70-82); per (user, positive) pair, ``n_negs`` sampled negatives
are mixed toward the positive with per-element U[0,1) alphas at EVERY
layer, the candidate with the largest inner product against the layer-mean
user embedding is chosen per layer (the index carries no gradient,
MixGCF.py:96-114), and the chosen negatives are averaged over layers. Loss
= BPR + l2(u, pos, neg) / batch_size (MixGCF.py:28). Eval is the
dropout-free propagation (MixGCF.py:117-128).

Draw order on ``generator``, the JAX package's key order (``split(key)``
into k_drop, k_mix; ``split(k_drop, n_layers)``; ``split(k_mix,
n_layers + 1)``): after the trainer's negatives, the n_layers keep masks,
one (n, D) ``torch.rand`` a hop, then the n_layers + 1 (B, n_negs, D)
alphas, layer 0 first. A resumed run restores the generator's state and
replays the same stream.
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops import losses
from selfrec_tpu_torch.ops.graph import spmm


class MixGCF(TorchGraphRecommender):
    dropout_rate = 0.1  # nn.Dropout(0.1), MixGCF.py:59

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.n_layers = int(args.get("n_layer", 3))
        self.n_negs = int(args.get("n_negs", 64))
        self.adj = self.make_adj()

    def _layerwise(self, params, drop_masks=None):
        """Per-layer (user, item) embedding lists; dropout where
        ``drop_masks`` (n_layers boolean keep masks) is given."""
        nu = self.data.user_num
        e = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        user_layers, item_layers = [params["user_emb"]], [params["item_emb"]]
        for k in range(self.n_layers):
            e = spmm(self.adj, e)
            if drop_masks is not None:
                e = torch.where(drop_masks[k], e / (1.0 - self.dropout_rate),
                                torch.zeros_like(e))
            user_layers.append(e[:nu])
            item_layers.append(e[nu:])
        return user_layers, item_layers

    def compute_embeddings(self, params):
        user_layers, item_layers = self._layerwise(params)
        return (torch.mean(torch.stack(user_layers), dim=0),
                torch.mean(torch.stack(item_layers), dim=0))

    def draw(self, generator, batch):
        """This step's keep masks and alphas, in the JAX package's key order."""
        n = self.data.user_num + self.data.item_num
        dev = batch["u"].device
        keep = 1.0 - self.dropout_rate
        drop_masks = [torch.rand((n, self.emb_size), generator=generator, device=dev) < keep
                      for _ in range(self.n_layers)]
        shape = (batch["u"].shape[0], self.n_negs, self.emb_size)
        alphas = [torch.rand(shape, generator=generator, device=dev)
                  for _ in range(self.n_layers + 1)]
        return drop_masks, alphas

    def mix_negatives(self, u_emb, item_layers, batch, alphas):
        """(B, D) synthesized negatives averaged over layers, and each
        layer's chosen candidate index (B,)."""
        neg, pos = batch["j"], batch["i"]
        rows = torch.arange(neg.shape[0], device=neg.device)
        chosen, picks = [], []
        for k, alpha in enumerate(alphas):
            neg_emb = item_layers[k][neg]  # (B, n_negs, D)
            pos_emb = item_layers[k][pos]  # (B, D)
            mixed = alpha * pos_emb[:, None, :] + (1.0 - alpha) * neg_emb
            scores = torch.sum(u_emb[:, None, :] * mixed, dim=-1)  # (B, n_negs)
            idx = torch.argmax(scores.detach(), dim=1)
            chosen.append(mixed[rows, idx])
            picks.append(idx)
        return torch.mean(torch.stack(chosen), dim=0), picks

    def batch_loss(self, params, batch, generator=None, drop_masks=None, alphas=None):
        """BPR + L2 over the mixed negatives; ``drop_masks`` and ``alphas``
        (see :meth:`draw`) replace the generator's draws in tests."""
        if drop_masks is None or alphas is None:
            drop_masks, alphas = self.draw(generator, batch)
        user_layers, item_layers = self._layerwise(params, drop_masks)
        user_final = torch.mean(torch.stack(user_layers), dim=0)
        u_emb = user_final[batch["u"]]
        neg_final, _ = self.mix_negatives(u_emb, item_layers, batch, alphas)
        item_final = torch.mean(torch.stack(item_layers), dim=0)
        pos_final = item_final[batch["i"]]
        mask = batch["mask"]
        rec = losses.bpr_loss(u_emb, pos_final, neg_final, mask=mask)
        reg = losses.l2_reg_loss(self.reg, u_emb, pos_final, neg_final,
                                 mask=mask) / self.batch_size
        return rec + reg
