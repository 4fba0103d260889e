"""CL4SRec of the port against the JAX package on small synth_sequences
data (tests/_seq_data.py), from JAX's initial weights, for each aug_type
(0 crop, 1 reorder, 2 mask): batch_loss and its grads with JAX's negatives
and both views' augmentation draws fed (and with dropout on, the three
encoders' keep masks), one Adam step, predict_scores and test()'s rec
lists. Tolerances: loss rtol 1e-5; grads and the stepped params rtol 1e-4
/ atol 1e-6; scores rtol 1e-5 / atol 1e-5; rec-list names exactly."""

import jax
import numpy as np
import pytest
import torch

from _seq_data import (aug_draw, check_loss_grads_and_adam_step, check_predict_scores,
                       check_rec_lists, keep_masks, model_pair, padded_batch)


def cl4srec_draws(tm):
    """cl4srec.py:47: k_enc, k_a1, k_a2, k_e1, k_e2 = split(key, 5)."""
    def draws_of(key, b, l):
        k_enc, k_a1, k_a2, k_e1, k_e2 = jax.random.split(key, 5)
        draws = {"aug": (aug_draw(tm.aug_type, k_a1, b, l), aug_draw(tm.aug_type, k_a2, b, l))}
        if tm.drop_rate > 0:
            draws["keep"] = tuple(keep_masks(k, tm.drop_rate, b, l, tm.emb_size, tm.n_heads,
                                             tm.n_blocks) for k in (k_enc, k_e1, k_e2))
        return draws
    return draws_of


@pytest.mark.parametrize("extra", [{"aug_type": 0}, {"aug_type": 1}, {"aug_type": 2},
                                   {"aug_type": 0, "drop_rate": 0.2}])
def test_batch_loss_grads_and_adam_step_match_jax(extra):
    jm, tm = model_pair("CL4SRec", extra)
    check_loss_grads_and_adam_step(jm, tm, cl4srec_draws(tm))


@pytest.mark.parametrize("aug_type", [0, 1, 2])
def test_the_views_change_the_loss(aug_type):
    """The contrastive term is live: two draws of the views give two
    losses, and cl_rate 0 leaves SASRec's loss."""
    jm, tm = model_pair("CL4SRec", {"aug_type": aug_type})
    _, tb = padded_batch(jm, np.arange(32), 32)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a = tm.batch_loss(tm.params, tb, gen)
        b = tm.batch_loss(tm.params, tb, gen)
        tm.cl_rate = 0.0
        c = tm.batch_loss(tm.params, tb, gen)
        d = tm.batch_loss(tm.params, tb, gen)
    assert float(a) != float(b)
    assert float(c) == float(d)


def test_predict_scores_match_jax():
    jm, tm = model_pair("CL4SRec")
    check_predict_scores(jm, tm)


def test_rec_lists_match_jax():
    jm, tm = model_pair("CL4SRec")
    check_rec_lists(jm, tm)


def test_vocab_has_the_mask_token():
    _, tm = model_pair("CL4SRec")
    assert tm.params["item_emb"].shape == (tm.data.item_num + 2, tm.emb_size)
    assert tm.params["pos_emb"].shape == (tm.max_len + 1, tm.emb_size)
