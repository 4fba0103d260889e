"""SASRec (counterpart of ``selfrec_tpu/models/sequential/sasrec.py``).

Capability parity with reference/model/sequential/SASRec.py: the causal
pre-LN transformer (:mod:`selfrec_tpu_torch.ops.transformer`),
BCE-with-logits on the positive and negative next-item logits at non-pad
positions, the two terms averaged separately (SASRec.py:44-53), plus
l2_reg over the WHOLE item table (SASRec.py:35). Prediction scores the
last position's output against the item table (SASRec.py:55-60).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from selfrec_tpu_torch.models.base import TorchSequentialRecommender
from selfrec_tpu_torch.ops import transformer
from selfrec_tpu_torch.ops.losses import l2_reg_loss


def bce_next_item_loss(seq_emb, item_emb, y, neg, valid):
    """Mean BCE over valid positions, positives and negatives averaged
    separately (sasrec.py:21-30)."""
    pos_logits = torch.sum(seq_emb * F.embedding(y, item_emb), dim=-1)
    neg_logits = torch.sum(seq_emb * F.embedding(neg, item_emb), dim=-1)
    v = valid.to(seq_emb.dtype)
    denom = torch.clamp(torch.sum(v), min=1.0)
    loss_pos = torch.sum(F.softplus(-pos_logits) * v) / denom
    loss_neg = torch.sum(F.softplus(neg_logits) * v) / denom
    return loss_pos + loss_neg


def last_position(seq_emb: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Row b's output at position lens[b] - 1, (B, D)
    (``take_along_axis`` in the JAX package)."""
    idx = (lens - 1).long()[:, None, None].expand(-1, 1, seq_emb.shape[-1])
    return torch.gather(seq_emb, 1, idx)[:, 0, :]


class SASRec(TorchSequentialRecommender):
    activation = "relu"
    causal = True

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.n_blocks = int(args.get("n_blocks", 2))
        self.drop_rate = float(args.get("drop_rate", 0.2))
        self.n_heads = int(args.get("n_heads", 1))

    def vocab_size(self):
        return self.data.item_num + 1  # + pad (SASRec.py:75)

    def n_positions(self):
        return self.max_len + 1

    def init_params(self, generator):
        return transformer.init_encoder_params(
            generator, self.vocab_size(), self.n_positions(), self.emb_size, self.n_blocks,
            device=self.device)

    def _encode(self, params, seq, pos, generator=None, keep=None):
        """The encoder; dropout on when ``generator`` or ``keep`` is given."""
        return transformer.encode(params, seq, pos, self.n_heads, self.drop_rate,
                                  causal=self.causal, activation=self.activation,
                                  generator=generator, keep=keep)

    def batch_loss(self, params, batch, generator=None, draws=None):
        """``draws``: {"keep": the encoder's keep masks}, or None to draw
        them from ``generator``."""
        draws = draws or {}
        seq_emb = self._encode(params, batch["seq"], batch["pos"], generator,
                               draws.get("keep"))
        valid = (batch["pos"] != 0) & (batch["row_mask"][:, None] > 0)
        rec = bce_next_item_loss(seq_emb, params["item_emb"], batch["y"], batch["neg"], valid)
        return rec + l2_reg_loss(self.reg, params["item_emb"])

    def predict_scores(self, params, seq, pos, seq_len):
        last = last_position(self._encode(params, seq, pos), seq_len)
        return last @ params["item_emb"].T
