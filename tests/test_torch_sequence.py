"""The port's sequential data layer and trainer against the JAX package,
and the sequential family end to end on the CPU.

- ``Sequence`` (a copy): ids, kept sequences, the first test item, and the
  padded train and test windows, exactly.
- The epoch's permutation and batches: equal to the JAX trainer's
  (base.py:895-906) element for element.
- The session and the CLI run each model on in-memory (or file) cyclic
  sequences on ``device="cpu"`` and beat random, with the bands of
  tests/test_sequential.py.
- A ``mesh`` above 1x1 and ``distributed`` raise naming ROADMAP.md §1.8.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from selfrec_tpu.data.sequence import Sequence as JaxSequence
from selfrec_tpu_torch import ModelConf, SelfRecTorch
from selfrec_tpu_torch.data.sequence import Sequence
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.ops import dense_dual, ell_gather
from selfrec_tpu_torch.utils import metrics

from _seq_data import model_pair, seq_conf_dict, seq_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("max_len", [2, 5, 12, 40])
def test_sequence_windows_equal_jax(max_len):
    train, test = seq_dataset()
    jd, td = JaxSequence(None, train, test), Sequence(None, train, test)
    assert td.item == jd.item and td.seq == jd.seq and td.original_seq == jd.original_seq
    assert dict(td.test_set) == dict(jd.test_set) and td.test_set_item == jd.test_set_item
    assert "short" not in td.seq and td.test_set["s0"] == {test["s0"][0]: 1}
    for got, want in zip(td.padded_training_arrays(max_len), jd.padded_training_arrays(max_len)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(td.padded_test_arrays(max_len), jd.padded_test_arrays(max_len)):
        np.testing.assert_array_equal(got, want)


def test_windows_are_left_aligned_with_item_0_as_the_pad():
    td = Sequence(None, {"a": ["x", "y", "z", "w"], "b": ["y", "x"]}, {"a": ["q"]})
    seq, pos, y, seq_len = td.padded_training_arrays(3)
    assert seq.tolist() == [[2, 3, 0], [2, 0, 0]] and y.tolist() == [[3, 4, 0], [1, 0, 0]]
    assert pos.tolist() == [[1, 2, 0], [1, 0, 0]] and seq_len.tolist() == [2, 1]
    seq, pos, seq_len = td.padded_test_arrays(3)
    assert seq.tolist() == [[2, 3, 4], [2, 1, 0]] and seq_len.tolist() == [3, 2]


@pytest.mark.parametrize("epoch", [0, 3])
def test_epoch_batches_equal_jax(epoch):
    """The port's (idx, row_mask) batches against the JAX trainer's
    (base.py:895-906, from its own epoch_rng): the same rows in the same
    batches, the last padded with row 0 and mask 0."""
    jm, tm = model_pair("SASRec")
    idx, row_mask = tm.epoch_batches(epoch)
    n = jm._seq_arr.shape[0]
    perm = jm.epoch_rng(epoch).permutation(n)
    bs = jm.batch_size
    pad = -(-n // bs) * bs - n
    want_idx = np.concatenate([perm, np.zeros(pad, perm.dtype)]).reshape(-1, bs)
    want_mask = np.concatenate([np.ones(n), np.zeros(pad)]).reshape(-1, bs)
    assert pad > 0
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(row_mask.numpy(), want_mask)
    for a_port, a_jax in zip(tm._train_arrays, (jm._seq_arr, jm._pos_arr, jm._y_arr,
                                                jm._len_arr)):
        np.testing.assert_array_equal(a_port[idx.numpy()], a_jax[want_idx])


def _cyclic_sequences():
    """tests/test_sequential.py's fixture: items cycle 0..19, each sequence
    walks the cycle from a random offset."""
    rng = np.random.default_rng(11)
    train, test = {}, {}
    for s in range(60):
        start = int(rng.integers(0, 20))
        length = int(rng.integers(6, 14))
        train[f"s{s}"] = [f"i{(start + k) % 20}" for k in range(length)]
        test[f"s{s}"] = [f"i{(start + length) % 20}"]
    return train, test


CYCLIC = {  # tests/test_sequential.py:125-155: extra, epochs, Recall@10 band
    "SASRec": ({"n_blocks": 1, "drop_rate": 0.1, "n_heads": 1}, 12, 0.5),
    "CL4SRec": ({"n_blocks": 1, "drop_rate": 0.1, "n_heads": 1, "aug_type": 0,
                 "aug_rate": 0.5, "cl_rate": 0.05}, 12, 0.5),
    "BERT4Rec": ({"n_blocks": 1, "drop_rate": 0.1, "n_heads": 1, "mask_rate": 0.3}, 20, 0.3),
}


@pytest.mark.parametrize("name", sorted(CYCLIC))
def test_session_trains_and_beats_random(tmp_path, name):
    """20-item catalog, random Recall@10 about 0.5: the JAX tests' bands.
    No kernel of the port runs on the sequential path."""
    extra, epochs, band = CYCLIC[name]
    train, test = _cyclic_sequences()
    conf = {
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": name, "type": "sequential"}, "item.ranking.topN": [5, 10],
        "embedding.size": 32, "max.epoch": epochs, "batch.size": 32, "learning.rate": 0.01,
        "reg.lambda": 0.0001, "max.len": 16, "output": str(tmp_path), "seed": 3, name: extra,
    }
    before = (dense_dual.dual_matmul.launches, ell_gather.ell_gather_sum.launches)
    rec_list = SelfRecTorch(ModelConf(conf), device="cpu", training_data=train,
                            test_data=test).execute()
    assert (dense_dual.dual_matmul.launches, ell_gather.ell_gather_sum.launches) == before
    assert set(rec_list) == set(train)
    perf = metrics.parse_measure(metrics.ranking_evaluation(
        {s: {v[0]: 1} for s, v in test.items()}, rec_list, [10]))
    assert perf["Recall"] > band, perf


def test_cli_runs_sasrec_on_the_cpu(tmp_path):
    """``python -m selfrec_tpu_torch --conf conf/SASRec.yaml`` on files in
    the ``seqid:item item ...`` format."""
    train, test = _cyclic_sequences()
    for name, rows in (("train.txt", train), ("test.txt", test)):
        with open(tmp_path / name, "w") as f:
            f.writelines(f"{s}:{' '.join(items)}\n" for s, items in rows.items())
    cmd = [sys.executable, "-m", "selfrec_tpu_torch", "--conf",
           os.path.join(REPO, "conf", "SASRec.yaml"), "--device", "cpu",
           "--set", f"training.set={tmp_path / 'train.txt'}",
           "--set", f"test.set={tmp_path / 'test.txt'}",
           "--set", "max.epoch=2", "--set", "batch.size=32", "--set", "max.len=16",
           "--set", "embedding.size=16", "--set", f"output={tmp_path / 'out'}/"]
    proc = subprocess.run(cmd, cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "Device: cpu" in proc.stdout and "sequence number: 60" in proc.stdout
    assert "Epoch: 2" in proc.stdout
    # evaluate() returns 0 and writes nothing, as the JAX package's
    assert not glob.glob(str(tmp_path / "out" / "*"))


@pytest.mark.parametrize("name", sorted(CYCLIC))
@pytest.mark.parametrize("key,value", [("mesh", {"data": 2}), ("mesh", {"model": 2}),
                                       ("distributed", True)])
def test_scale_out_keys_raise_naming_the_roadmap(name, key, value):
    train, test = seq_dataset()
    conf = ModelConf(dict(seq_conf_dict(name), **{key: value}))
    with pytest.raises(NotImplementedError, match="§1.8"):
        get_model_class(name)(conf, train, test, device="cpu")


def test_one_by_one_mesh_is_the_single_device_path():
    train, test = seq_dataset()
    conf = ModelConf(dict(seq_conf_dict("SASRec"), mesh={"data": 1, "model": 1}))
    model = get_model_class("SASRec")(conf, train, test, device="cpu")
    model.build()
    assert model.params["item_emb"].device == torch.device("cpu")
