"""The sequential trainer family (``TorchSequentialRecommender``): the
program built from the harness's sequences, the calls the window drives,
the spans of the traced run, and what is kept of the window for the check.

- Training steps: ``epoch_batches`` (the epoch's permutation of rows),
  then ``train_batches`` (the graph runner), as ``run_epoch`` calls them;
  set-up drives the check steps through these same calls, which also warm
  up and capture the step. The graph is kept across epochs.
- An eval: ``fast_evaluation``, which ranks through ``top_items`` (one
  graph replay a block), builds ``test()``'s lists on the host and scores
  them; the ranked ids and the lists are kept."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.families import common
from benchmark.reference import judge, synth
from benchmark.reference.metrics import ranking_metrics

SAMPLES = "seqs"


def make_inputs(data: dict, seed: int) -> dict:
    return synth.sequences(seed, data["sequences"], data["items"], data["mean_length"],
                           data["structure_seed"])


def item_name(i: int) -> str:
    return f"i{i}"


class Program:
    def __init__(self, cfg: dict, conf: dict, inputs: dict, device, spans):
        from selfrec_tpu_torch.config import ModelConf
        from selfrec_tpu_torch.models import get_model_class

        lens, items = inputs["lengths"], inputs["items"]
        names = np.array([item_name(i) for i in range(inputs["n_items"] + 1)], dtype=object)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        train, test = {}, {}
        for r, (s, n) in enumerate(zip(starts, lens)):
            train[f"s{r}"] = names[items[s:s + n]].tolist()
            t = int(inputs["test"][r])
            test[f"s{r}"] = [item_name(t) if t > 0 else f"unseen{r}"]
        self.model = get_model_class(cfg["model"])(ModelConf(conf), train, test, device=device)
        self.model.build()
        self.device = device
        self.inputs = inputs
        self.spans = spans
        self.last = {}
        m = self.model
        for attr in ("top_items", "test"):
            fn = getattr(m, attr)

            def kept(*args, _fn=fn, _attr=attr, **kwargs):
                self.last[_attr] = _fn(*args, **kwargs)
                return self.last[_attr]

            spans.patch(m, attr, kept)

    def samples_per_epoch(self) -> int:
        return len(self.inputs["lengths"])

    def set_state(self, params, draw_seed: int):
        self.model.set_params(params)
        self.model.generator.manual_seed(draw_seed)

    def check_steps(self, n_steps: int, params0) -> dict:
        """The first ``n_steps`` steps of epoch 0 through the runner; the
        loss of each, each leaf's first gradient (from Adam's first moment
        after one step) and each leaf's change after the last."""
        m = self.model
        idx, row_mask = m.epoch_batches(0)
        losses = m.train_batches(idx[:1], row_mask[:1]).tolist()
        grad1 = common.first_gradient_norms(m.optimizer, m.params)
        losses += m.train_batches(idx[1:n_steps], row_mask[1:n_steps]).tolist()
        delta = common.change_norms(m.params, params0)
        self.batches = [(idx[s].cpu(), row_mask[s].cpu()) for s in range(n_steps)]
        return {"loss": losses, "grad1": grad1, "delta": delta}

    def train_epoch(self, epoch: int) -> np.ndarray:
        return self.model.run_epoch(epoch)

    def evaluate(self, epoch: int):
        self.last_measure = self.model.fast_evaluation(epoch)

    def trace_spans(self):
        from selfrec_tpu_torch.utils import metrics

        sp, m = self.spans, self.model
        sp.wrap(m, "top_items", "eval.rank",
                sync=self.device if self.device.type == "cuda" else None)
        ranked = {}
        top = m.top_items

        def top_items(*args, **kwargs):
            out = top(*args, **kwargs)
            ranked["end"] = time.perf_counter()
            return out

        sp.patch(m, "top_items", top_items)
        test = m.test

        def host_lists(*args, **kwargs):
            with sp.span("eval.test"):
                out = test(*args, **kwargs)
            sp.add("eval.host", time.perf_counter() - ranked["end"])
            return out

        sp.patch(m, "test", host_lists)
        sp.wrap(metrics, "ranking_evaluation", "eval.host")

    kernel_launches = staticmethod(common.k1_launches)

    def answers(self) -> dict:
        scores, ids = self.last["top_items"]
        return {"scores": scores.float().cpu(), "ids": ids.cpu().numpy(),
                "lists": self.last["test"], "metrics": judge.parse_measure(self.last_measure)}

    def free(self):
        self.model.release_graphs()
        self.model = None


def check_batches(inputs, batches, device) -> int:
    """Rows of the program's check batches that are out of range, repeat
    another, or are masked out: each must be a distinct sequence."""
    rows = torch.cat([b[0] for b in batches])
    mask = torch.cat([b[1] for b in batches])
    n = len(inputs["lengths"])
    return (int(((rows < 0) | (rows >= n)).sum()) + rows.numel() - torch.unique(rows).numel()
            + int((mask != 1).sum()))


def reference_batches(batches, device) -> list:
    """The check batches as the reference takes them: row indices."""
    return [b[0].to(device) for b in batches]


def eval_numbers(scorer, answers: dict) -> dict:
    """score_gap, rank_gap, rank_bad, list_bad and metric_gap of the
    program's last eval."""
    ids, scores = answers["ids"], answers["scores"]
    out = judge.rank_numbers(scorer, ids)
    gap, best0 = 0.0, []
    for lo in range(0, ids.shape[0], 1024):
        s = scorer.scores(lo, lo + 1024).float().cpu()
        got = torch.gather(s, 1, torch.as_tensor(ids[lo:lo + 1024]).clamp(0, s.shape[1] - 1))
        gap = max(gap, float((scores[lo:lo + 1024] - got).abs().max()))
        best0.append(s.max(dim=1).values.abs())
    out["score_gap"] = gap / max(float(torch.median(torch.cat(best0))), 1e-30)
    # test()'s lists: the ranked ids with the pad id dropped, by name
    keep = (ids > 0) & (ids <= scorer.n_items)
    recs, bad = [], 0
    lists = answers["lists"]
    for r, key in enumerate(f"s{k}" for k in range(ids.shape[0])):
        want = [item_name(int(i)) for i in ids[r][keep[r]]]
        got = [name for name, _ in lists.get(key, [])]
        bad += got != want
        recs.append([int(name[1:]) for name in got])
    out["list_bad"] = bad + abs(len(lists) - ids.shape[0])
    out["metric_gap"] = judge.metric_gap(answers["metrics"], scorer.truth, recs, scorer.k)
    return out


def reference_answers(scorer) -> dict:
    """The reference's own eval answers in the program's form (for the
    control and the planted faults)."""
    scores, ids = [], []
    for lo in range(0, len(scorer.truth), 1024):
        top = torch.topk(scorer.scores(lo, lo + 1024), scorer.k, dim=1)
        scores.append(top.values.float().cpu())
        ids.append(top.indices.cpu())
    scores, ids = torch.cat(scores), torch.cat(ids).numpy()
    keep = (ids > 0) & (ids <= scorer.n_items)
    lists = {f"s{r}": [(item_name(int(i)), 0.0) for i in ids[r][keep[r]]]
             for r in range(ids.shape[0])}
    recs = [[int(i) for i in ids[r][keep[r]]] for r in range(ids.shape[0])]
    return {"scores": scores, "ids": ids, "lists": lists,
            "metrics": ranking_metrics(scorer.truth, recs, scorer.k)}
