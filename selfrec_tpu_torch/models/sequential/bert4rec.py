"""BERT4Rec (counterpart of ``selfrec_tpu/models/sequential/bert4rec.py``).

Capability parity with reference/model/sequential/BERT4Rec.py: a
bidirectional (no causal mask) gelu transformer over an item_num+2
vocabulary (mask token item_num+1, BERT4Rec.py:99); training masks
max(floor(len * mask_rate), 1) random positions of each sequence and
cross-entropies the masked positions over the whole vocabulary, with the
reference's double division: the CE summed over masked entries divided
by the masked count TWICE (BERT4Rec.py:57-62), plus full-table item L2.
Inference appends the mask token after the sequence, shifting full
windows left, and scores position seq_len - 1 (BERT4Rec.py:64-77: for a
sequence shorter than the window that is the last REAL item's position,
not the appended mask's; kept for parity, as the JAX package keeps it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from selfrec_tpu_torch.models.sequential.sasrec import SASRec, last_position
from selfrec_tpu_torch.ops import seq_sampling
from selfrec_tpu_torch.ops.losses import l2_reg_loss


class BERT4Rec(SASRec):
    activation = "gelu"
    causal = False

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        args = conf[self.model_name] if conf.contain(self.model_name) else {}
        self.mask_rate = float(args.get("mask_rate", 0.5))

    def vocab_size(self):
        return self.data.item_num + 2

    def n_positions(self):
        return self.max_len + 2  # BERT4Rec.py:100

    def batch_loss(self, params, batch, generator=None, draws=None):
        """``draws``: {"mask": the (B, L) uniforms of the masked positions,
        "keep": the encoder's keep masks}; what is absent is drawn from
        ``generator``, the mask first."""
        draws = draws or {}
        seq = batch["seq"]
        seq_len = torch.clamp(batch["seq_len"], min=1)
        aug_seq, chosen = seq_sampling.bert_mask(
            generator, seq, seq_len, self.mask_rate, self.data.item_num + 1,
            draws.get("mask"))
        # gate out padded rows and positions beyond the window
        l = seq.shape[1]
        chosen = (chosen
                  & (torch.arange(l, device=seq.device)[None, :] < batch["seq_len"][:, None])
                  & (batch["row_mask"][:, None] > 0))
        aug_seq = torch.where(chosen, aug_seq, seq)
        seq_emb = self._encode(params, aug_seq, batch["pos"], generator, draws.get("keep"))
        # full-vocab logits only at the masked positions, gathered into a
        # fixed-K buffer: the chosen positions first, lowest index first,
        # as lax.top_k over the 0/1 mask orders them (bert4rec.py:56-71)
        k_sel = min(l, max(int(l * self.mask_rate), 1))
        sel_val, sel_idx = torch.sort(chosen.to(torch.int32), dim=1, descending=True,
                                      stable=True)
        sel_val, sel_idx = sel_val[:, :k_sel], sel_idx[:, :k_sel]
        valid = sel_val > 0
        emb_sel = torch.gather(seq_emb, 1,
                               sel_idx[..., None].expand(-1, -1, seq_emb.shape[-1]))
        labels_sel = torch.gather(seq, 1, sel_idx)
        logits = emb_sel @ params["item_emb"].T  # (B, K, vocab)
        ce = -torch.gather(F.log_softmax(logits, dim=-1), -1, labels_sel[..., None])[..., 0]
        n_masked = torch.clamp(torch.sum(chosen).to(ce.dtype), min=1.0)
        rec = torch.sum(torch.where(valid, ce, torch.zeros_like(ce))) / n_masked / n_masked
        return rec + l2_reg_loss(self.reg, params["item_emb"])

    def predict_scores(self, params, seq, pos, seq_len):
        """Mask token appended (or a full window shifted left, the mask
        last), then the output at position seq_len - 1 (bert4rec.py:76-97)."""
        b, l = seq.shape
        mask_id = self.data.item_num + 1
        at_end = torch.arange(l, device=seq.device)[None, :] == seq_len[:, None]
        full = (seq_len == l)[:, None]
        app_seq = torch.where(at_end, torch.full_like(seq, mask_id), seq)
        app_pos = torch.where(at_end, (seq_len[:, None] + 1).to(pos.dtype), pos)
        sh_seq = torch.cat([seq[:, 1:], torch.full((b, 1), mask_id, dtype=seq.dtype,
                                                    device=seq.device)], dim=1)
        sh_pos = torch.cat([pos[:, 1:], seq_len[:, None].to(pos.dtype)], dim=1)
        seq2 = torch.where(full, sh_seq, app_seq)
        pos2 = torch.where(full, sh_pos, app_pos)
        last = last_position(self._encode(params, seq2, pos2), seq_len)
        return last @ params["item_emb"].T
