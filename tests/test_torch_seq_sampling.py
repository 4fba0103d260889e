"""The port's sequence draws (selfrec_tpu_torch/ops/seq_sampling.py) against
selfrec_tpu/ops/seq_sampling.py.

Each JAX function runs with a key; JAX's draws from that key are replayed
in JAX's key order (tests/_seq_data.py) and fed to the port, whose outputs
must then equal JAX's exactly. Windows come from small synth_sequences
data: left-aligned, 0 as the pad, lengths 2-11 in a window of 12, plus
rows of length 1 (the ``max(len, 1)`` the models pass for empty rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.ops import seq_sampling as jss
from selfrec_tpu_torch.ops import seq_sampling as tss

from _seq_data import (MAX_LEN, crop_draw, neg_draws, positions_draw, reorder_draw,
                       seq_dataset, t)


@pytest.fixture(scope="module")
def windows():
    from selfrec_tpu.data.sequence import Sequence

    train, test = seq_dataset()
    seq, pos, _, seq_len = Sequence(None, train, test).padded_training_arrays(MAX_LEN)
    seq, pos, seq_len = seq[:64].copy(), pos[:64].copy(), seq_len[:64].copy()
    seq[-2:], pos[-2:], seq_len[-2:] = 0, 0, 1  # padded rows, as the eval pads
    seq[-3, 1:], pos[-3, 1:], seq_len[-3] = 0, 0, 1  # a one-item window
    return seq, pos, seq_len


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_negatives_equal_jax_with_its_draws_fed(windows, seed):
    """A small catalog (12 items) so that candidates land in the window
    and the redraw rounds matter; pads get 0."""
    seq, _, _ = windows
    seq = np.minimum(seq, 12)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jss.sample_seq_negatives(key, jnp.asarray(seq), 12))
    draws = neg_draws(key, seq.shape, 12)
    got = tss.sample_seq_negatives(None, t(seq).long(), 12, draws=draws)
    np.testing.assert_array_equal(got.numpy(), want)
    redrawn = (got.numpy() != draws[0].numpy()) & (seq != 0)
    assert redrawn.any()
    assert (got.numpy()[seq == 0] == 0).all()


def test_negatives_drawn_from_the_generator_avoid_the_window(windows):
    seq, _, _ = windows
    gen = torch.Generator().manual_seed(0)
    neg = tss.sample_seq_negatives(gen, t(seq).long(), 500)
    s = t(seq).long()
    assert ((neg >= 1) & (neg <= 500))[s != 0].all() and (neg[s == 0] == 0).all()
    assert not torch.any((neg[:, :, None] == s[:, None, :]) & (s[:, None, :] != 0))


@pytest.mark.parametrize("ratio", [0.2, 0.5, 0.9])
def test_item_crop_equals_jax(windows, ratio):
    seq, _, seq_len = windows
    key = jax.random.PRNGKey(3)
    want = jss.item_crop(key, jnp.asarray(seq), jnp.asarray(seq_len), ratio)
    got = tss.item_crop(None, t(seq).long(), t(seq_len).long(), ratio,
                        u=crop_draw(key, seq.shape[0]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ratio", [0.2, 0.5, 0.9])
def test_item_reorder_equals_jax(windows, ratio):
    seq, _, seq_len = windows
    key = jax.random.PRNGKey(4)
    want = np.asarray(jss.item_reorder(key, jnp.asarray(seq), jnp.asarray(seq_len), ratio))
    got = tss.item_reorder(None, t(seq).long(), t(seq_len).long(), ratio,
                           u=reorder_draw(key, *seq.shape))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.sort(want, axis=1) == np.sort(seq, axis=1)).all()


@pytest.mark.parametrize("ratio", [0.2, 0.5, 0.9])
def test_item_mask_equals_jax(windows, ratio):
    seq, _, seq_len = windows
    key = jax.random.PRNGKey(5)
    want = np.asarray(jss.item_mask(key, jnp.asarray(seq), jnp.asarray(seq_len), ratio, 41))
    got = tss.item_mask(None, t(seq).long(), t(seq_len).long(), ratio, 41,
                        u=positions_draw(key, *seq.shape))
    np.testing.assert_array_equal(got.numpy(), want)
    # floor(len * ratio) in f32: 10 * 0.9 rounds to 9 there, not 8
    np.testing.assert_array_equal((want == 41).sum(1),
                                  np.floor(seq_len.astype(np.float32) * np.float32(ratio)))


@pytest.mark.parametrize("ratio", [0.2, 0.5])
def test_bert_mask_equals_jax(windows, ratio):
    """At least one position a row; the ``inf`` lanes past the length tie
    and rank by position under the stable sort."""
    seq, _, seq_len = windows
    key = jax.random.PRNGKey(6)
    want_seq, want_chosen = jss.bert_mask(key, jnp.asarray(seq), jnp.asarray(seq_len),
                                          ratio, 41)
    got_seq, got_chosen = tss.bert_mask(None, t(seq).long(), t(seq_len).long(), ratio, 41,
                                        u=positions_draw(key, *seq.shape))
    np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))
    np.testing.assert_array_equal(got_chosen.numpy(), np.asarray(want_chosen))
    assert (got_chosen.sum(1).numpy() >= 1).all()


def test_rand_starts_truncate_in_f32():
    """start = trunc(u * max(len - span, 1)), the product in f32 as JAX
    computes it (seq_sampling.py:51-56): u just under 1 stays below the top
    start, and a span as long as the row starts at 0."""
    u = np.array([0.0, 0.5, 0.99999994, 0.3], dtype=np.float32)
    seq_len = np.array([10, 10, 10, 1], dtype=np.int32)
    span = np.array([4, 9, 4, 0], dtype=np.int32)
    got = tss._rand_starts(t(u), t(seq_len).long(), t(span).long())
    want = (u * np.maximum(seq_len - span, 1).astype(np.float32)).astype(np.int32)
    assert got.tolist() == want.tolist() == [0, 0, 5, 0]
