"""SSL4Rec, two-tower retrieval with feature-dropout contrast (counterpart
of ``selfrec_tpu/models/graph/ssl4rec.py``).

Capability parity with reference/model/graph/SSL4Rec.py: user and item
towers Linear(D, 1024) -> ReLU -> Linear(1024, 128) -> tanh over
Xavier-initialised id embeddings (SSL4Rec.py:64-78); rec loss the in-batch
sampled softmax at tau (SSL4Rec.py:33); SSL = alpha * InfoNCE between two
inverted-dropout views of the batch's raw item rows, each through the item
tower (SSL4Rec.py:90-103); plus l2_reg(query, item), not scaled by the
batch (SSL4Rec.py:35). The trainer's negatives go unused, as in the
reference. No adjacency, so no kernel launch.

Draw order on ``generator``, the JAX package's (``split(key)`` into k1,
k2): after the trainer's negatives, view 1's keep mask, then view 2's, each
a (B, D) ``torch.rand < 1 - drop``.
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.convert import flatten_params
from selfrec_tpu_torch.models.base import TorchGraphRecommender
from selfrec_tpu_torch.ops import losses
from selfrec_tpu_torch.ops.init import layer_params, linear_apply, torch_linear_params


class SSL4Rec(TorchGraphRecommender):
    tower_hidden = 1024
    tower_out = 128

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.cl_rate = float(args.get("alpha", 0.1))
        self.tau = float(args.get("tau", 0.07))
        self.drop_rate = float(args.get("drop", 0.1))

    def init_params(self, generator):
        params = super().init_params(generator)

        def tower():
            return [torch_linear_params(generator, self.emb_size, self.tower_hidden,
                                        device=self.device),
                    torch_linear_params(generator, self.tower_hidden, self.tower_out,
                                        device=self.device)]

        params.update(flatten_params({"user_tower": tower(), "item_tower": tower()}))
        return params

    @staticmethod
    def _tower(params, name, x):
        h = torch.relu(linear_apply(layer_params(params, f"{name}.0"), x))
        return torch.tanh(linear_apply(layer_params(params, f"{name}.1"), h))

    def compute_embeddings(self, params):
        return (self._tower(params, "user_tower", params["user_emb"]),
                self._tower(params, "item_tower", params["item_emb"]))

    def draw(self, generator, shape, device):
        """The two views' keep masks, in the JAX package's key order."""
        keep = 1.0 - self.drop_rate
        return [torch.rand(shape, generator=generator, device=device) < keep
                for _ in range(2)]

    def batch_loss(self, params, batch, generator=None, drop_masks=None):
        """Softmax + L2 + alpha * InfoNCE; ``drop_masks`` (two (B, D) keep
        masks, see :meth:`draw`) replace the generator's draws in tests."""
        q_emb = self._tower(params, "user_tower", params["user_emb"][batch["u"]])
        i_raw = params["item_emb"][batch["i"]]
        i_emb = self._tower(params, "item_tower", i_raw)
        mask = batch["mask"]
        rec = losses.batch_softmax_loss(q_emb, i_emb, self.tau, mask=mask)
        if drop_masks is None:
            drop_masks = self.draw(generator, i_raw.shape, i_raw.device)
        keep = 1.0 - self.drop_rate
        v1, v2 = (torch.where(m, i_raw / keep, torch.zeros_like(i_raw)) for m in drop_masks)
        cl = losses.infonce(self._tower(params, "item_tower", v1),
                            self._tower(params, "item_tower", v2), self.tau, mask=mask)
        reg = losses.l2_reg_loss(self.reg, q_emb, i_emb, mask=mask)
        return rec + reg + self.cl_rate * cl
