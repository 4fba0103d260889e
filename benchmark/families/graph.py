"""The graph trainer family (``TorchGraphRecommender``): the program built
from the harness's arrays, the calls the window drives, the spans of the
traced run, and what is kept of the window for the check.

- Training steps: ``epoch_batches`` (the epoch's shuffled pairs), then
  ``begin_epoch`` and ``train_batches`` (the graph runner), as
  ``run_epoch`` calls them; set-up drives the check steps through these
  same calls, which also warm up and capture the step.
- An eval: ``embeddings()`` then ``fast_evaluation``, as ``train()``
  runs them after an epoch; the top ids it ranked are kept from
  ``ranking.topk_ids_from_embeddings``."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.families import common
from benchmark.reference import graph as ref_graph
from benchmark.reference import judge, synth
from benchmark.reference.metrics import ranking_metrics

SAMPLES = "pairs"


def make_inputs(data: dict, seed: int) -> dict:
    return synth.graph_arrays(seed, data["users"], data["items"], data["interactions"],
                              data["structure_seed"])


class Program:
    def __init__(self, cfg: dict, conf: dict, inputs: dict, device, spans):
        from selfrec_tpu_torch.config import ModelConf
        from selfrec_tpu_torch.models import get_model_class
        from selfrec_tpu_torch.ops import ranking

        nu, ni = inputs["n_users"], inputs["n_items"]
        mapped = (inputs["train_u"].astype(np.int32), inputs["train_i"].astype(np.int32),
                  np.ones(len(inputs["train_u"]), np.float32),
                  [f"u{k}" for k in range(nu)], [f"i{k}" for k in range(ni)])
        test = [(f"u{u}", f"i{i}", 1.0) for u, i in zip(inputs["test_u"], inputs["test_i"])]
        self.model = get_model_class(cfg["model"])(ModelConf(conf), mapped, test, device=device)
        self.model.build()
        self.device = device
        self.inputs = inputs
        self.spans = spans
        self.last_ids = None
        self.last_measure = None
        keep = ranking.topk_ids_from_embeddings

        def kept(*args, **kwargs):
            self.last_ids = keep(*args, **kwargs)
            return self.last_ids

        spans.patch(ranking, "topk_ids_from_embeddings", kept)

    def samples_per_epoch(self) -> int:
        return len(self.inputs["train_u"])

    def set_state(self, params, draw_seed: int):
        self.model.set_params(params)
        self.model.generator.manual_seed(draw_seed)

    def check_steps(self, n_steps: int, params0) -> dict:
        """The first ``n_steps`` steps of epoch 0 through the runner; the
        loss of each, each leaf's first gradient (from Adam's first moment
        after one step) and each leaf's change after the last."""
        m = self.model
        users, items, masks = m.epoch_batches(0)
        m.begin_epoch(0)
        losses = m.train_batches(users[:1], items[:1], masks[:1]).tolist()
        grad1 = common.first_gradient_norms(m.optimizer, m.params)
        losses += m.train_batches(users[1:n_steps], items[1:n_steps], masks[1:n_steps]).tolist()
        delta = common.change_norms(m.params, params0)
        self.batches = [(users[s].cpu(), items[s].cpu(), masks[s].cpu()) for s in range(n_steps)]
        return {"loss": losses, "grad1": grad1, "delta": delta}

    def train_epoch(self, epoch: int) -> np.ndarray:
        return self.model.run_epoch(epoch)

    def evaluate(self, epoch: int):
        m = self.model
        m.user_emb, m.item_emb = m.embeddings()
        self.last_measure = m.fast_evaluation(epoch)

    def trace_spans(self):
        from selfrec_tpu_torch.ops import dense_dual, ranking
        from selfrec_tpu_torch.utils import metrics

        sp, m = self.spans, self.model
        sp.wrap(m, "embeddings", "eval.rank")
        sp.wrap(ranking, "topk_ids_from_embeddings", "eval.rank")
        sp.wrap(metrics, "ranking_evaluation_ids", "eval.host")
        self.k1_calls = []
        record = self.k1_calls.append
        for attr in ("float_products", "dual_matmul"):
            fn = getattr(dense_dual, attr)

            def counted(b, bt, xu, xi, *rest, _fn=fn, _attr=attr):
                if _attr == "float_products" or xu.dtype == torch.int8:
                    record((b.shape[0], b.shape[1], xu.shape[1], str(xu.dtype).split(".")[-1],
                            torch.cuda.is_current_stream_capturing()))
                return _fn(b, bt, xu, xi, *rest)

            def undo(fn=fn, attr=attr):
                # the wrapped function counts its launches on whatever
                # the module's name holds
                fn.launches = getattr(dense_dual, attr).launches
                setattr(dense_dual, attr, fn)

            counted.launches = fn.launches
            setattr(dense_dual, attr, counted)
            sp.on_close(undo)

    kernel_launches = staticmethod(common.k1_launches)

    def answers(self) -> dict:
        m = self.model
        return {"user_emb": m.user_emb.float().cpu(), "item_emb": m.item_emb.float().cpu(),
                "ids": np.asarray(self.last_ids),
                "metrics": judge.parse_measure(self.last_measure)}

    def free(self):
        self.model.release_graphs()
        self.model = None


def check_batches(inputs, batches, device) -> int:
    """Rows of the program's check batches that are not a training pair, or
    repeat another, or are masked out: each must be one."""
    keys = ref_graph.rated_keys(inputs["train_u"], inputs["train_i"], inputs["n_items"], device)
    u = torch.cat([b[0] for b in batches]).to(device)
    i = torch.cat([b[1] for b in batches]).to(device)
    mask = torch.cat([b[2] for b in batches]).to(device)
    pairs = u * inputs["n_items"] + i
    repeats = pairs.numel() - torch.unique(pairs).numel()
    return int((~ref_graph.is_rated(keys, u, i, inputs["n_items"])).sum()) + repeats + int(
        (mask != 1).sum())


def reference_batches(batches, device) -> list:
    """The check batches as the reference takes them: (users, items)."""
    return [(b[0].to(device), b[1].to(device)) for b in batches]


def eval_numbers(scorer, answers: dict) -> dict:
    """emb_gap, rank_gap, rank_bad and metric_gap of the program's last eval."""
    ref_u, ref_i = scorer.user_emb.float().cpu(), scorer.item_emb.float().cpu()
    scale = max(float(ref_u.abs().max()), float(ref_i.abs().max()))
    emb_gap = max(float((answers["user_emb"] - ref_u).abs().max()),
                  float((answers["item_emb"] - ref_i).abs().max())) / scale
    out = {"emb_gap": emb_gap}
    out.update(judge.rank_numbers(scorer, answers["ids"]))
    out["metric_gap"] = judge.metric_gap(answers["metrics"], scorer.truth,
                                         answers["ids"].tolist(), scorer.k)
    return out


def reference_answers(scorer) -> dict:
    """The reference's own eval answers in the program's form (for the
    control and the planted faults): its embeddings, its top ids and
    SELFRec's metrics over them."""
    ids = []
    for lo in range(0, len(scorer.truth), 1024):
        ids.append(torch.topk(scorer.scores(lo, lo + 1024), scorer.k, dim=1).indices.cpu())
    ids = torch.cat(ids).numpy()
    return {"user_emb": scorer.user_emb.float().cpu(), "item_emb": scorer.item_emb.float().cpu(),
            "ids": ids, "metrics": ranking_metrics(scorer.truth, ids.tolist(), scorer.k)}
