"""The step graphs of the port's trainers and sequential eval
(selfrec_tpu_torch.utils.cuda_graph, the trainers' ``train_batches`` and
the sequential ``top_items``): the counterpart of the JAX package's
one-dispatch epoch and scanned eval (selfrec_tpu/models/base.py:500-570,
733-759).

On the CPU a step graph runs its static step eagerly, reading the batch
from its persistent buffers at the device step counter and writing aux in
place, so the static step is held here against plain eager steps
(``eager_batches``), bit for bit; the graphed eval blocks are held against
the eager block loop and the JAX package's scanned eval on the same
weights. A fake graph object stands in for
``torch.cuda.CUDAGraph`` to show that the kernel launch counts add their
captured increments on every replay. One test captures on the card and is
marked ``cuda``."""

import copy

import pytest
import torch

from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.models.base import SequentialRecommender
from selfrec_tpu_torch.ops import dense_dual, ell_gather
from selfrec_tpu_torch.utils import checkpoint as ckpt
from selfrec_tpu_torch.utils.cuda_graph import StepGraph
from selfrec_tpu_torch.utils.synth import synth_graph_mapped

GRAPH_CASES = {
    "SimGCL-int8": ({"n_layer": 2, "lambda": 0.5, "eps": 0.1},
                    {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "int8"}),
    # a new dropped view each epoch: the step is captured again
    "SGL-ell": ({"n_layer": 2, "lambda": 0.1, "drop_rate": 0.1, "aug_type": 1, "temp": 0.2},
                {"SELFREC_TPU_DENSE": "0"}),
    # aux (the momentum targets) moved by step_update, written in place
    "BUIR-ell": ({"n_layer": 2, "drop_rate": 0.2, "tau": 0.995}, {"SELFREC_TPU_DENSE": "0"}),
}


def _graph_model(case, monkeypatch, batch=128):
    extra, env = GRAPH_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    name = case.split("-")[0]
    train, test = synth_graph_mapped(300, 400, 4000, seed=5)
    conf = ModelConf({
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": name, "type": "graph"}, "item.ranking.topN": [10, 20],
        "embedding.size": 16, "max.epoch": 2, "batch.size": batch, "learning.rate": 0.01,
        "reg.lambda": 0.0001, "output": "unused", "seed": 3, name: extra})
    model = get_model_class(name)(conf, train, test, device="cpu")
    model.build()
    return model


def _seq_model(name):
    from _seq_data import seq_conf_dict, seq_dataset  # JAX beside the port

    train, test = seq_dataset()
    model = get_model_class(name)(ModelConf(seq_conf_dict(name)), train, test, device="cpu")
    model.build()
    return model


def _state(model, losses):
    out = {f"loss {e}": l for e, l in enumerate(losses)}
    for k, p in model.params.items():
        out[f"param {k}"] = p.detach().clone()
        for s, v in model.optimizer.state[p].items():
            out[f"{s} {k}"] = v.clone()
    for k, v in getattr(model, "aux", {}).items():
        out[f"aux {k}"] = v.clone()
    return out


def _epochs(model, run, n_epochs=2):
    losses = []
    for epoch in range(n_epochs):
        batches = model.epoch_batches(epoch)
        if hasattr(model, "begin_epoch"):
            model.begin_epoch(epoch)
        losses.append(run(*batches))
    return _state(model, losses)


@pytest.mark.parametrize("case", sorted(GRAPH_CASES) + ["SASRec", "BERT4Rec"])
def test_static_step_equals_eager_steps(case, monkeypatch):
    """Two epochs through the step graph's static step (run eagerly on the
    CPU) give the losses, params, Adam state and aux of plain eager
    steps, bit for bit."""
    make = ((lambda: _graph_model(case, monkeypatch)) if case in GRAPH_CASES
            else (lambda: _seq_model(case)))
    eager, graphed = make(), make()
    want = _epochs(eager, eager.eager_batches)
    got = _epochs(graphed, graphed.train_batches)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    runner = graphed._graphs["train"]
    assert not runner.graphed and runner.captures == 0
    assert not eager._graphs


def test_train_batches_on_the_cpu_runs_eager_and_says_why(monkeypatch, capsys):
    model = _graph_model("SimGCL-int8", monkeypatch)
    users, items, masks = model.epoch_batches(0)
    model.train_batches(users[:2], items[:2], masks[:2])
    assert "[graph] SimGCL DenseAdj int8 train: eager (CPU: no CUDA graphs)" in \
        capsys.readouterr().out
    runner = model._graphs["train"]
    assert model.step_graph_eager_reason() == "CPU: no CUDA graphs"
    assert not runner.graphed and runner.captures == 0 and runner.replays == 0


def _saved(model):
    """The checkpoint's state, copied (on the CPU ``train_state`` holds the
    live tensors)."""
    return copy.deepcopy(ckpt.train_state(model))


def _addresses(model):
    return ([p.data_ptr() for p in model.params.values()]
            + [v.data_ptr() for st in model.optimizer.state.values() for v in st.values()])


@pytest.mark.parametrize("case", ["SimGCL-int8", "BUIR-ell", "SASRec"])
def test_set_params_and_resume_keep_addresses(case, monkeypatch):
    """Once a step graph holds the params, Adam's state and aux,
    ``set_params`` and a resume write into them in place: every
    ``data_ptr`` stays; set_params leaves a fresh Adam's state (zeros),
    the resume the checkpoint's values."""
    model = _graph_model(case, monkeypatch) if case in GRAPH_CASES else _seq_model(case)
    batches = model.epoch_batches(0)
    model.train_batches(*(b[:3] for b in batches))
    saved = _saved(model)
    model.train_batches(*(b[3:5] for b in batches))
    ptrs = _addresses(model)
    aux_ptrs = [v.data_ptr() for v in getattr(model, "aux", {}).values()]

    fresh = model.init_params(torch.Generator().manual_seed(9))
    model.set_params(fresh)
    assert _addresses(model) == ptrs
    for k, v in fresh.items():
        assert torch.equal(model.params[k].detach(), v.float())
    assert all(not v.any() for st in model.optimizer.state.values() for v in st.values())

    ckpt.apply_train_state(model, saved)
    assert _addresses(model) == ptrs
    assert [v.data_ptr() for v in getattr(model, "aux", {}).values()] == aux_ptrs
    for k, v in saved["params"].items():
        assert torch.equal(model.params[k].detach(), v)
    for i, p in enumerate(model.params.values()):
        for s, v in saved["optimizer"]["state"][i].items():
            assert torch.equal(model.optimizer.state[p][s], v), (i, s)
    for k, v in saved["aux"].items():
        assert torch.equal(model.aux[k], v)


def test_resumed_steps_through_the_graph_equal_the_checkpointed_run(monkeypatch):
    """After an in-place resume the static steps continue as the run they
    were saved from did."""
    model = _graph_model("BUIR-ell", monkeypatch)
    batches = model.epoch_batches(0)
    model.train_batches(*(b[:2] for b in batches))
    saved = _saved(model)
    first = model.train_batches(*(b[2:6] for b in batches))
    want = _state(model, [first])
    ckpt.apply_train_state(model, saved)
    again = model.train_batches(*(b[2:6] for b in batches))
    got = _state(model, [again])
    for k in want:
        assert torch.equal(got[k], want[k]), k


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: its capture runs
    the callable once (a real capture records the launches and runs no
    work), a replay only counts."""

    made = []

    def __init__(self, generators=()):
        self.replays = 0
        FakeGraph.made.append(self)

    def capture(self, fn):
        fn()

    def replay(self):
        self.replays += 1

    def reset(self):
        pass


def test_replays_add_the_captured_launch_counts():
    """Warm-up steps count their launches as they run; the capture's
    launches are taken back and added again on every replay, so the counts
    stay the launches that ran; a replaced input warms up and captures
    again."""
    FakeGraph.made.clear()

    def step():
        dense_dual.dual_matmul.launches += 3
        ell_gather.ell_gather_sum.launches += 2

    graph = StepGraph(step, "cpu", "fake step", warmup=2, new_graph=FakeGraph)
    dense_dual.dual_matmul.launches = ell_gather.ell_gather_sum.launches = 0
    held = object()
    graph.track(held)
    for _ in range(7):
        graph()
    assert (dense_dual.dual_matmul.launches, ell_gather.ell_gather_sum.launches) == (21, 14)
    assert graph.graphed and graph.captures == 1 and graph.replays == 5
    assert FakeGraph.made[0].replays == 5 and len(graph.capture_ms) == 1

    graph.track(held)  # the same input: the graph stays
    graph()
    assert graph.captures == 1 and graph.replays == 6
    graph.track(object())  # a new optimizer or aux: warm up, capture again
    for _ in range(4):
        graph()
    assert graph.captures == 2 and graph.replays == 8 and FakeGraph.made[1].replays == 2
    assert dense_dual.dual_matmul.launches == 3 * 12
    assert ell_gather.ell_gather_sum.launches == 2 * 12
    graph.close()
    assert graph.graph is None and graph.fn is None
    dense_dual.dual_matmul.launches = ell_gather.ell_gather_sum.launches = 0


@pytest.mark.parametrize("case", ["BUIR-ell", "SGL-ell"])
def test_every_epoch_captures_its_step_again(case, monkeypatch):
    """``epoch_setup`` may rebind what the captured step reads, whether it
    returns a new aux (SGL) or the held one (BUIR), so ``run_epoch`` drops
    the train graph: each epoch warms up and captures once. A fake graph
    stands in for the card's."""
    FakeGraph.made.clear()
    model = _graph_model(case, monkeypatch)
    monkeypatch.setattr(model, "step_graph_eager_reason", lambda: None)
    monkeypatch.setattr(model, "graph_class", FakeGraph)
    n = model.epoch_batches(0)[0].shape[0]
    for epoch in range(2):
        model.run_epoch(epoch)
        runner = model._graphs["train"]
        assert runner.graphed and runner.captures == epoch + 1
        assert runner.replays == (epoch + 1) * (n - runner.warmup)
    assert [g.replays for g in FakeGraph.made] == [n - 2, n - 2]


def test_a_failed_capture_raises_naming_the_graph():
    class Refusing(FakeGraph):
        def capture(self, fn):
            raise RuntimeError("operation not permitted when stream is capturing")

    graph = StepGraph(lambda: None, "cpu", "SimGCL DenseAdj int8 train", warmup=0,
                      new_graph=Refusing)
    with pytest.raises(RuntimeError, match=r"\[graph\] SimGCL DenseAdj int8 train: capture "
                                           r"failed in .*not permitted"):
        graph()
    assert graph.graph is None and graph.captures == 0


@pytest.mark.parametrize("name", ["SASRec", "BERT4Rec"])
def test_graphed_eval_blocks_equal_jax_scanned_eval(name):
    """The eval graph's static block (run eagerly on the CPU: encoder,
    scores and top-k at the device block counter) gives the JAX package's
    scanned eval (``_test_scan_jit``) on the same weights: the same names
    in the same order, scores within rtol 1e-5; and the eager block loop's
    ids and scores exactly."""
    from _seq_data import check_rec_lists, model_pair

    jm, tm = model_pair(name)
    want = SequentialRecommender.top_items(tm)
    got = tm.top_items()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert tm._graphs["eval"].captures == 0
    check_rec_lists(jm, tm)


@pytest.mark.cuda
def test_step_graph_captures_and_replays_on_the_card(monkeypatch):
    """On the card: SimGCL int8x8's step captured once and replayed, K1's
    launches counted per replay, and the graphed steps bit-equal to eager
    steps from the same state. Run with ``python -m pytest --noconftest -m
    cuda tests/test_torch_step_graph.py`` on a machine with the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    for k, v in GRAPH_CASES["SimGCL-int8"][1].items():
        monkeypatch.setenv(k, v)
    train, test = synth_graph_mapped(300, 400, 4000, seed=5)
    conf = ModelConf({
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "SimGCL", "type": "graph"}, "item.ranking.topN": [10, 20],
        "embedding.size": 16, "max.epoch": 1, "batch.size": 128, "learning.rate": 0.01,
        "reg.lambda": 0.0001, "output": "unused", "seed": 3,
        "SimGCL": GRAPH_CASES["SimGCL-int8"][0]})
    model = get_model_class("SimGCL")(conf, train, test, device="cuda")
    model.build()
    users, items, masks = model.epoch_batches(0)
    dense_dual.dual_matmul.launches = 0
    model.train_batches(users[:6], items[:6], masks[:6])
    runner = model._graphs["train"]
    assert runner.graphed and runner.captures == 1 and runner.replays == 4
    assert dense_dual.dual_matmul.launches == 6 * 2 * 2
    saved = _saved(model)
    graphed = _state(model, [model.train_batches(users[6:11], items[6:11], masks[6:11])])
    ckpt.apply_train_state(model, saved)
    eager = _state(model, [model.eager_batches(users[6:11], items[6:11], masks[6:11])])
    for k in eager:
        assert torch.equal(graphed[k], eager[k]), k
    model.release_graphs()
    assert not model._graphs
