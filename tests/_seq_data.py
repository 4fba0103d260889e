"""Shared inputs of the sequential tests of the port (tests/test_torch_
{sequence,seq_sampling,transformer,sasrec,cl4srec,bert4rec}.py).

Small ``synth_sequences`` data (120 sequences over 40 items, lengths 3-30
against a window of 12), plus a sequence too short to keep and a test
sequence with two items; the same model of both packages on the same
weights; and JAX's random draws replayed in JAX's key order, to be fed to
the port (torch cannot replay ``jax.random``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from selfrec_tpu.config import ModelConf as JaxConf
from selfrec_tpu.models import get_model_class as jax_model_class
from selfrec_tpu_torch import convert
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.utils.synth import synth_sequences

MAX_LEN = 12
EXTRA = {
    "SASRec": {"n_blocks": 2, "drop_rate": 0.0, "n_heads": 1},
    "CL4SRec": {"n_blocks": 2, "drop_rate": 0.0, "n_heads": 2, "aug_type": 0,
                "aug_rate": 0.5, "cl_rate": 0.1},
    "BERT4Rec": {"n_blocks": 2, "drop_rate": 0.0, "n_heads": 2, "mask_rate": 0.5},
}


def seq_dataset():
    train, test = synth_sequences(n_seqs=120, n_items=40, seed=5)
    train["short"] = ["i1"]  # fewer than 2 items: dropped
    test["short"] = ["i2"]
    test["s0"] = test["s0"] + ["i3"]  # only the first test item is kept
    return train, test


def seq_conf_dict(name, extra=None, **top):
    conf = {
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": name, "type": "sequential"},
        "item.ranking.topN": [5, 10], "embedding.size": 16, "max.epoch": 2,
        "batch.size": 32, "learning.rate": 0.01, "reg.lambda": 0.0001,
        "max.len": MAX_LEN, "output": "/tmp/selfrec_tpu_torch_seq_results/", "seed": 3,
        name: dict(EXTRA[name], **(extra or {})),
    }
    conf.update({k.replace("_", "."): v for k, v in top.items()})
    return conf


def model_pair(name, extra=None, dataset=None, **top):
    """(JAX model, port model on the CPU) on the same data, both built,
    the port holding JAX's initial weights."""
    train, test = dataset or seq_dataset()
    conf = seq_conf_dict(name, extra, **top)
    jm = jax_model_class(name)(JaxConf(conf), train, test)
    jm.build()
    tm = get_model_class(name)(ModelConf(conf), train, test, device="cpu")
    tm.build()
    tm.set_params(convert.params_from_jax(jm.params, device="cpu"))
    return jm, tm


def padded_batch(jm, rows, n_valid, neg_key=11):
    """Rows ``rows`` of JAX's padded training arrays, row_mask 1 on the first
    ``n_valid``, and JAX's negatives for them: (numpy dict, torch dict)."""
    rows = np.asarray(rows)
    batch = {"seq": jm._seq_arr[rows], "pos": jm._pos_arr[rows], "y": jm._y_arr[rows],
             "seq_len": jm._len_arr[rows],
             "row_mask": (np.arange(len(rows)) < n_valid).astype(np.float32)}
    from selfrec_tpu.ops.seq_sampling import sample_seq_negatives

    batch["neg"] = np.asarray(sample_seq_negatives(
        jax.random.PRNGKey(neg_key), jnp.asarray(batch["seq"]), jm.data.item_num))
    return batch, to_torch(batch)


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)).float() if k == "row_mask"
            else torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


# -- JAX's draws, replayed in JAX's key order ----------------------------------

def neg_draws(key, shape, item_num, n_rounds=4):
    """sample_seq_negatives' candidates: round 0 from keys[0], round r from
    fold_in(keys[-1], r) (seq_sampling.py:28-48)."""
    keys = jax.random.split(key, n_rounds)
    rounds = [jax.random.randint(keys[0], shape, 1, item_num + 1, dtype=jnp.int32)]
    rounds += [jax.random.randint(jax.random.fold_in(keys[-1], r), shape, 1, item_num + 1,
                                  dtype=jnp.int32) for r in range(1, n_rounds)]
    return t(np.stack([np.asarray(r) for r in rounds])).long()


def crop_draw(key, b):
    return t(jax.random.uniform(key, (b,)))


def reorder_draw(key, b, l):
    k_start, k_perm = jax.random.split(key)
    return t(jax.random.uniform(k_start, (b,))), t(jax.random.uniform(k_perm, (b, l)))


def positions_draw(key, b, l):
    """_pick_k_positions' uniforms (item_mask, bert_mask)."""
    return t(jax.random.uniform(key, (b, l)))


def aug_draw(aug_type, key, b, l):
    if aug_type == 0:
        return crop_draw(key, b)
    if aug_type == 1:
        return reorder_draw(key, b, l)
    return positions_draw(key, b, l)


def keep_masks(key, rate, b, l, d, n_heads, n_blocks):
    """encode's dropout keep masks: split(key, 2 n_blocks + 1), the
    embedding's (B, L, D), then per block the attention weights' (B, H, L, L)
    and the FFN output's (B, L, D) (transformer.py:110-141)."""
    keys = jax.random.split(key, 2 * n_blocks + 1)
    shapes = [(b, l, d)] + [s for _ in range(n_blocks) for s in ((b, n_heads, l, l), (b, l, d))]
    return [t(jax.random.bernoulli(k, 1.0 - rate, s)) for k, s in zip(keys, shapes)]


def jax_params(tm):
    """The port's params as the JAX package's tree of arrays."""
    return jax.tree_util.tree_map(jnp.asarray, convert.params_to_jax(tm.params))


def grads_of(tm, tb, draws):
    """The port's loss and grads on ``tb`` with ``draws`` fed."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in tm.params.items()}
    loss = tm.batch_loss(params, tb, None, draws=draws)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in params.items()}


def assert_grads_close(grads, jgrads, rtol=1e-4, atol=1e-6):
    flat = convert.flatten_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(flat) == set(grads)
    for k, v in grads.items():
        np.testing.assert_allclose(v.numpy(), flat[k], rtol=rtol, atol=atol, err_msg=k)


def jax_loss_and_grads(jm, batch, key):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.value_and_grad(jm.batch_loss)(jm.params, jb, key)


def check_loss_grads_and_adam_step(jm, tm, draws_of, rows=None, n_valid=28, key_seed=7):
    """batch_loss and its grads (loss rtol 1e-5; grads rtol 1e-4 / atol
    1e-6), then one Adam step of both packages from JAX's grads (params
    within the grads' tolerance). The same grads, because the attention's
    key bias has an analytically zero grad (softmax ignores a shift common
    to a row's scores): both packages give rounding noise there, which
    Adam's first step scales up to ±lr. ``draws_of(key, b, l)`` replays
    the JAX model's draws from its loss key, in the port's ``draws`` form.
    The batch is 32 rows, the last ``32 - n_valid`` padded (row_mask 0)."""
    import optax

    rows = np.arange(32) if rows is None else rows
    batch, tb = padded_batch(jm, rows, n_valid)
    key = jax.random.PRNGKey(key_seed)
    draws = draws_of(key, *batch["seq"].shape)
    jloss, jgrads = jax_loss_and_grads(jm, batch, key)
    loss, grads = grads_of(tm, tb, draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_grads_close(grads, jgrads)

    updates, _ = jm.optimizer.update(jgrads, jm.opt_state, jm.params)
    jnew = convert.flatten_params(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(jm.params, updates)))
    jflat = convert.flatten_params(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, v in tm.params.items():
        v.grad = torch.from_numpy(jflat[k].copy())
    tm.optimizer.step()
    for k, v in tm.params.items():
        np.testing.assert_allclose(v.detach().numpy(), jnew[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    return float(loss)


def check_predict_scores(jm, tm, rows=None):
    """predict_scores over test windows, the encoder's tolerance."""
    seq, pos, seq_len = jm.data.padded_test_arrays(MAX_LEN)
    rows = np.arange(40) if rows is None else rows
    want = np.asarray(jm.predict_scores(jm.params, jnp.asarray(seq[rows]),
                                        jnp.asarray(pos[rows]), jnp.asarray(seq_len[rows])))
    with torch.no_grad():
        got = tm.predict_scores(tm.params, t(seq[rows]).long(), t(pos[rows]).long(),
                                t(seq_len[rows]).long())
    assert got.shape == (len(rows), tm.vocab_size())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def check_rec_lists(jm, tm):
    """test(): the same names in the same order, scores rtol 1e-5; the
    last block is padded (120 sequences in blocks of 32) and some lists are
    short (pad or mask ids filtered after the top-k)."""
    want, got = jm.test(), tm.test()
    n = len(tm.data.original_seq)
    assert n % tm.batch_size != 0 and list(got) == list(want)
    for name in want:
        assert [nm for nm, _ in got[name]] == [nm for nm, _ in want[name]], name
        np.testing.assert_allclose([s for _, s in got[name]], [s for _, s in want[name]],
                                   rtol=1e-5, atol=1e-6)
    assert any(len(v) < tm.max_N for v in got.values())
    assert all(len(v) <= tm.max_N for v in got.values())
