"""CL4SRec (counterpart of ``selfrec_tpu/models/sequential/cl4srec.py``).

Capability parity with reference/model/sequential/CL4SRec.py: SASRec's
encoder over an item_num+2 vocabulary (mask token item_num+1,
CL4SRec.py:23-25), SASRec's BCE next-item loss and full-table item L2,
plus cl_rate x InfoNCE(tau=1, cosine) between the last-position outputs
of two augmented views: crop (aug_type 0, new positions and lengths),
reorder (1) or mask (2) (CL4SRec.py:37-58), drawn on the device
(:mod:`selfrec_tpu_torch.ops.seq_sampling`).
"""

from __future__ import annotations

import torch

from selfrec_tpu_torch.models.sequential.sasrec import (
    SASRec, bce_next_item_loss, last_position)
from selfrec_tpu_torch.ops import seq_sampling
from selfrec_tpu_torch.ops.losses import infonce, l2_reg_loss


class CL4SRec(SASRec):
    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.aug_type = int(args.get("aug_type", 0))
        self.aug_rate = float(args.get("aug_rate", 0.5))
        self.cl_rate = float(args.get("cl_rate", 0.05))

    def vocab_size(self):
        return self.data.item_num + 2  # + pad + mask token (CL4SRec.py:24)

    def _augment(self, generator, seq, pos, seq_len, u=None):
        """One augmented view -> (seq, pos, last_len) (cl4srec.py:33-45);
        ``u`` is the augmentation's draw (seq_sampling), or None to draw."""
        if self.aug_type == 0:
            return seq_sampling.item_crop(generator, seq, seq_len, self.aug_rate, u)
        if self.aug_type == 1:
            return seq_sampling.item_reorder(generator, seq, seq_len, self.aug_rate, u), \
                pos, seq_len
        aug = seq_sampling.item_mask(generator, seq, seq_len, self.aug_rate,
                                     self.data.item_num + 1, u)
        return aug, pos, seq_len

    def batch_loss(self, params, batch, generator=None, draws=None):
        """``draws``: {"aug": the two views' augmentation draws, "keep": the
        main and the two views' encoder keep masks}; what is absent is drawn
        from ``generator``, in the order main encoder, view 1 and 2's
        augmentations, view 1 and 2's encoders."""
        draws = draws or {}
        u1, u2 = draws.get("aug", (None, None))
        k0, k1, k2 = draws.get("keep", (None, None, None))
        seq_emb = self._encode(params, batch["seq"], batch["pos"], generator, k0)
        valid = (batch["pos"] != 0) & (batch["row_mask"][:, None] > 0)
        rec = bce_next_item_loss(seq_emb, params["item_emb"], batch["y"], batch["neg"], valid)

        seq_len = torch.clamp(batch["seq_len"], min=1)
        s1, p1, l1 = self._augment(generator, batch["seq"], batch["pos"], seq_len, u1)
        s2, p2, l2 = self._augment(generator, batch["seq"], batch["pos"], seq_len, u2)
        e1 = self._encode(params, s1, p1, generator, k1)
        e2 = self._encode(params, s2, p2, generator, k2)
        cl = infonce(last_position(e1, l1), last_position(e2, l2), 1.0, b_cos=True,
                     mask=batch["row_mask"])
        return rec + l2_reg_loss(self.reg, params["item_emb"]) + self.cl_rate * cl
