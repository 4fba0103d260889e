"""BERT4Rec of the port against the JAX package on small synth_sequences
data (tests/_seq_data.py), from JAX's initial weights: batch_loss and its
grads with JAX's mask draw fed (and with dropout on, the encoder's keep
masks), one Adam step, predict_scores and test()'s rec lists. Two quirks
of the JAX package are matched: the CE divided by the masked count twice,
and predict_scores reading position seq_len - 1. Tolerances: loss rtol
1e-5; grads and the stepped params rtol 1e-4 / atol 1e-6; scores rtol
1e-5 / atol 1e-5; rec-list names exactly."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from selfrec_tpu_torch.ops import seq_sampling
from selfrec_tpu_torch.ops.losses import l2_reg_loss

from _seq_data import (check_loss_grads_and_adam_step, check_predict_scores, check_rec_lists,
                       keep_masks, model_pair, padded_batch, positions_draw)


def bert4rec_draws(tm):
    """bert4rec.py:41: k_mask, k_enc = split(key)."""
    def draws_of(key, b, l):
        k_mask, k_enc = jax.random.split(key)
        draws = {"mask": positions_draw(k_mask, b, l)}
        if tm.drop_rate > 0:
            draws["keep"] = keep_masks(k_enc, tm.drop_rate, b, l, tm.emb_size, tm.n_heads,
                                       tm.n_blocks)
        return draws
    return draws_of


@pytest.mark.parametrize("extra", [{}, {"mask_rate": 0.2}, {"drop_rate": 0.2}])
def test_batch_loss_grads_and_adam_step_match_jax(extra):
    jm, tm = model_pair("BERT4Rec", extra)
    check_loss_grads_and_adam_step(jm, tm, bert4rec_draws(tm))


def test_loss_is_divided_by_the_masked_count_twice():
    """The gathered CE equals the full-grid CE over the masked positions,
    summed and divided by the masked count twice (bert4rec.py:72-73), plus
    the item table's l2 term."""
    jm, tm = model_pair("BERT4Rec")
    batch, tb = padded_batch(jm, np.arange(32), 30)
    u = positions_draw(jax.random.PRNGKey(3), *batch["seq"].shape)
    with torch.no_grad():
        loss = tm.batch_loss(tm.params, tb, None, draws={"mask": u})
        seq, seq_len = tb["seq"], tb["seq_len"]
        aug, chosen = seq_sampling.bert_mask(None, seq, seq_len.clamp(min=1), 0.5,
                                             tm.data.item_num + 1, u=u)
        chosen &= (torch.arange(seq.shape[1])[None] < seq_len[:, None]) & \
            (tb["row_mask"][:, None] > 0)
        emb = tm._encode(tm.params, torch.where(chosen, aug, seq), tb["pos"])
        ce = F.cross_entropy((emb @ tm.params["item_emb"].T)[chosen], seq[chosen],
                             reduction="sum")
        n = float(chosen.sum())
        want = ce / n / n + l2_reg_loss(tm.reg, tm.params["item_emb"])
    assert n > 32
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)


def test_predict_scores_match_jax():
    """Full windows are shifted left with the mask token last; shorter ones
    get it appended; both read position seq_len - 1."""
    jm, tm = model_pair("BERT4Rec")
    seq_len = jm.data.padded_test_arrays(12)[2]
    rows = np.r_[np.flatnonzero(seq_len == 12)[:20], np.flatnonzero(seq_len < 12)[:20]]
    assert len(rows) == 40
    check_predict_scores(jm, tm, rows)


def test_rec_lists_match_jax():
    jm, tm = model_pair("BERT4Rec")
    check_rec_lists(jm, tm)


def test_vocab_and_positions():
    _, tm = model_pair("BERT4Rec")
    assert tm.params["item_emb"].shape == (tm.data.item_num + 2, tm.emb_size)
    assert tm.params["pos_emb"].shape == (tm.max_len + 2, tm.emb_size)
    assert tm.causal is False and tm.activation == "gelu"
