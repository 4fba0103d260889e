"""SASRec of the port against the JAX package on small synth_sequences
data (tests/_seq_data.py), from JAX's initial weights: batch_loss and its
grads with JAX's negatives fed (and with dropout on, JAX's keep masks
fed), one Adam step, predict_scores and test()'s rec lists. Tolerances:
loss rtol 1e-5; grads and the stepped params rtol 1e-4 / atol 1e-6;
scores rtol 1e-5 / atol 1e-5; rec-list names exactly."""

import numpy as np
import pytest
import torch

from _seq_data import (check_loss_grads_and_adam_step, check_predict_scores, check_rec_lists,
                       keep_masks, model_pair, padded_batch)


def sasrec_draws(tm):
    def draws_of(key, b, l):
        if tm.drop_rate <= 0:
            return None
        return {"keep": keep_masks(key, tm.drop_rate, b, l, tm.emb_size, tm.n_heads,
                                   tm.n_blocks)}
    return draws_of


@pytest.mark.parametrize("extra", [{}, {"drop_rate": 0.2, "n_heads": 2}, {"n_blocks": 1}])
def test_batch_loss_grads_and_adam_step_match_jax(extra):
    jm, tm = model_pair("SASRec", extra)
    loss = check_loss_grads_and_adam_step(jm, tm, sasrec_draws(tm))
    assert np.isfinite(loss)


def test_padded_rows_do_not_count():
    """Rows with row_mask 0 do not count: a batch whose padded rows hold
    other sequences has the same loss (rtol 1e-6)."""
    jm, tm = model_pair("SASRec")
    _, full = padded_batch(jm, np.arange(32), 20)
    _, part = padded_batch(jm, np.r_[np.arange(20), np.arange(40, 52)], 20)
    part["neg"][:20] = full["neg"][:20]
    with torch.no_grad():
        a = tm.batch_loss(tm.params, full, None)
        b = tm.batch_loss(tm.params, part, None)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_predict_scores_match_jax():
    jm, tm = model_pair("SASRec")
    check_predict_scores(jm, tm)


def test_rec_lists_match_jax():
    jm, tm = model_pair("SASRec")
    check_rec_lists(jm, tm)


def test_vocab_and_positions():
    jm, tm = model_pair("SASRec")
    assert tm.params["item_emb"].shape == (tm.data.item_num + 1, tm.emb_size)
    assert tm.params["pos_emb"].shape == (tm.max_len + 1, tm.emb_size)
    fresh = tm.init_params(torch.Generator().manual_seed(0))
    assert list(fresh) == list(tm.params)
    assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in tm.params.items()}
