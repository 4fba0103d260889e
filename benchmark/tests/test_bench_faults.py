"""The check comes out false when the timed path is broken underneath: a
step that leaves the state unchanged, half of each batch left out (the
mean over the rest), and an answer altered where it is produced. The run
is the harness's own, on the CPU at a small size, past its look for a
card. (No cell spans chips, so there is no exchange to leave out.)"""

import time

import numpy as np
import pytest

from _small import SEED, cell_of, small
from benchmark.core import harness
from selfrec_tpu_torch.models import base
from selfrec_tpu_torch.ops import ranking

TRAIN = ["SimGCL-yelp2018.train", "SASRec-amazon-beauty.train"]


def _run(cell):
    return harness.run(cell_of(cell), SEED + 7, 0.0, False, "cpu", time.perf_counter(),
                       overrides=small(cell))


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged_fails(cell, monkeypatch):
    monkeypatch.setattr(base._TrainStateMixin, "_optimizer_step", lambda self: None)
    out = _run(cell)
    assert out["correct"] is False
    assert out["checks"]["delta_gap"][0] > out["checks"]["delta_gap"][1]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_left_out_fails(cell, monkeypatch):
    key = "mask" if cell.startswith("SimGCL") else "row_mask"
    cls = base.TorchGraphRecommender if key == "mask" else base.TorchSequentialRecommender
    step_batch = cls.step_batch

    def halved(self, rows):
        batch = dict(step_batch(self, rows))
        m = batch[key].clone()
        m[m.shape[0] // 2:] = 0
        batch[key] = m
        return batch

    monkeypatch.setattr(cls, "step_batch", halved)
    out = _run(cell)
    assert out["correct"] is False
    assert out["checks"]["loss_gap"][0] > out["checks"]["loss_gap"][1]


def test_graph_answer_altered_fails(monkeypatch):
    topk = ranking.topk_ids_from_embeddings

    def altered(data, *args, **kwargs):
        ids = np.array(topk(data, *args, **kwargs))
        ids[:, 0] = (ids[:, 0] + 1) % data.item_num
        return ids

    monkeypatch.setattr(ranking, "topk_ids_from_embeddings", altered)
    out = _run("SimGCL-yelp2018.eval")
    assert out["correct"] is False


def test_sequential_answer_altered_fails(monkeypatch):
    top_items = base.TorchSequentialRecommender.top_items

    def altered(self):
        scores, ids = top_items(self)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % (self.data.item_num + 1)
        return scores, ids

    monkeypatch.setattr(base.TorchSequentialRecommender, "top_items", altered)
    out = _run("SASRec-amazon-beauty.eval")
    assert out["correct"] is False
