"""The port's spans (selfrec_tpu_torch.utils.trace) and where the trainers
put them.

Off (no profiler) a span adds only host totals: no ``record_function``
range, no CUDA event, and the step path no span at all. Under a CPU
``torch.profiler`` the spans are ranges of the exported Chrome trace, by
name and nesting. The trainers record the set-up spans when built, and the
runner, rank and metrics spans in order when they run an epoch and an eval;
the step graph waits for queued work in ``runner.drain``, before its capture
clock starts. Device spans need the card: their events are faked here."""

import contextlib
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.ops import dense_dual
from selfrec_tpu_torch.utils import cuda_graph, trace
from selfrec_tpu_torch.utils.cuda_graph import StepGraph
from selfrec_tpu_torch.utils.synth import synth_graph_mapped, synth_sequences


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: its capture runs
    the callable once, a replay only counts."""

    def __init__(self, generators=()):
        self.replays = 0

    def capture(self, fn):
        fn()

    def replay(self):
        self.replays += 1

    def reset(self):
        pass


class FakeEvent:
    """A CUDA event whose elapsed time to any later event is 1.5 ms."""

    made = []

    def __init__(self, enable_timing=False):
        self.stream = None
        self.synced = False
        FakeEvent.made.append(self)

    def record(self, stream=None):
        self.stream = stream

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        assert end.synced
        return 1.5


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA events, streams and the capture flag as the card would give
    them, so that device_span runs its card path on the CPU."""
    FakeEvent.made.clear()
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    return FakeEvent


PROGRAM = ("setup.", "runner.", "rank.", "metrics.")


def _ranges(prof, tmp_path):
    """The program's ``user_annotation`` ranges of ``prof``'s Chrome trace
    (torch's own, such as the optimizer's, left out) as (name, start, end),
    in order of start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat") == "user_annotation" and e.get("ph") == "X"
           and e["name"].startswith(PROGRAM)]
    return sorted(out, key=lambda r: r[1])


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


# -- the module -------------------------------------------------------------------


def test_span_off_adds_host_totals_and_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trace.reset()
    assert not trace.profiling()
    for _ in range(3):
        with trace.span("setup.data"):
            time.sleep(0.002)
    got = trace.totals(profiled=False)["setup.data"]
    assert got.count == 3 and got.host_s >= 0.006 and got.device_count == 0
    assert "setup.data" not in trace.totals(profiled=True)


@pytest.mark.parametrize("case", ["no profiler", "the CPU", "a capture"])
def test_device_span_records_no_event_off_the_profiled_card(case, fake_card, monkeypatch):
    trace.reset()
    if case == "a capture":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    device = "cpu" if case == "the CPU" else "cuda"
    with _cpu_profile() if case != "no profiler" else contextlib.nullcontext():
        with trace.device_span("rank.topk", device):
            pass
    assert fake_card.made == []
    assert "rank.topk" not in trace.totals()


def test_device_span_pairs_resolve_when_read(fake_card):
    """Under a profiler on the card each block records a start and an end
    event on the device's stream; the pairs stay pending until totals()
    reads them, which waits for each end event first."""
    trace.reset()
    with _cpu_profile():
        for _ in range(4):
            with trace.device_span("rank.score", "cuda"):
                pass
            with trace.device_span("rank.topk", "cuda"):
                pass
    assert len(fake_card.made) == 16 and all(e.stream == "stream" for e in fake_card.made)
    assert not any(e.synced for e in fake_card.made)
    got = trace.totals(profiled=True)
    assert (got["rank.score"].device_count, got["rank.score"].device_ms) == (4, 6.0)
    assert (got["rank.topk"].device_count, got["rank.topk"].device_ms) == (4, 6.0)
    assert got["rank.topk"].count == 0  # a device span adds no host span
    assert trace.totals()["rank.score"].device_ms == 6.0  # read once, kept
    assert "rank.score" not in trace.totals(profiled=False)


def test_spans_under_a_cpu_profiler_are_nested_ranges(tmp_path):
    trace.reset()
    with trace.span("setup.params"):
        pass
    with _cpu_profile() as prof:
        assert trace.profiling()
        with trace.span("runner.replays"):
            with trace.span("runner.warmup"):
                time.sleep(0.001)
            with trace.span("runner.capture"):
                time.sleep(0.001)
    assert not trace.profiling()
    ranges = _ranges(prof, tmp_path)
    names = [r[0] for r in ranges]
    assert names == ["runner.replays", "runner.warmup", "runner.capture"]
    outer = ranges[0]
    assert all(outer[1] <= a and b <= outer[2] for _, a, b in ranges[1:])
    assert ranges[1][2] <= ranges[2][1]
    on, off = trace.totals(profiled=True), trace.totals(profiled=False)
    assert set(on) == {"runner.replays", "runner.warmup", "runner.capture"}
    assert set(off) == {"setup.params"} and off["setup.params"].count == 1
    assert on["runner.replays"].host_s >= on["runner.warmup"].host_s + \
        on["runner.capture"].host_s


def test_a_span_inside_its_own_name_counts_once_and_survives_a_raise():
    trace.reset()
    with trace.span("setup.adj"):
        with trace.span("setup.adj"):
            pass
    with pytest.raises(ValueError):
        with trace.span("setup.adj"):
            raise ValueError("build failed")
    with trace.span("setup.adj"):
        pass
    assert trace.totals()["setup.adj"].count == 3


# -- the trainers -----------------------------------------------------------------


def _simgcl(**extra):
    train, test = synth_graph_mapped(120, 150, 1500, seed=5)
    conf = ModelConf({
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "SimGCL", "type": "graph"}, "item.ranking.topN": [5, 10],
        "embedding.size": 16, "max.epoch": 2, "batch.size": 128, "learning.rate": 0.01,
        "reg.lambda": 0.0001, "output": "unused", "seed": 3,
        "SimGCL": {"n_layer": 2, "lambda": 0.5, "eps": 0.1}, **extra})
    model = get_model_class("SimGCL")(conf, train, test, device="cpu")
    model.build()
    return model


def _sasrec():
    train, test = synth_sequences(n_seqs=120, n_items=40, seed=5)
    conf = ModelConf({
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "SASRec", "type": "sequential"}, "item.ranking.topN": [5, 10],
        "embedding.size": 16, "max.epoch": 2, "batch.size": 32, "learning.rate": 0.01,
        "reg.lambda": 0.0001, "max.len": 12, "output": "unused", "seed": 3,
        "SASRec": {"n_blocks": 2, "drop_rate": 0.0, "n_heads": 1}})
    model = get_model_class("SASRec")(conf, train, test, device="cpu")
    model.build()
    return model


@pytest.mark.parametrize("name, want", [
    ("SimGCL", {"setup.data": 1, "setup.adj": 1, "setup.params": 1, "setup.sampler": 1}),
    # the sequences, then the sequential trainer's padded windows
    ("SASRec", {"setup.data": 2, "setup.params": 1}),
])
def test_build_records_the_setup_spans(name, want):
    model = _simgcl() if name == "SimGCL" else _sasrec()
    got = trace.totals(profiled=False)
    assert {k: v.count for k, v in got.items()} == want
    assert all(v.host_s > 0 for v in got.values())
    model.set_params({k: v.detach() for k, v in model.params.items()})
    assert trace.totals()["setup.params"].count == want["setup.params"] + 1


def test_each_recommender_starts_a_fresh_record():
    _simgcl()
    with trace.span("eval.mine"):
        pass
    _sasrec()
    assert set(trace.totals()) == {"setup.data", "setup.params"}


GRAPH_EPOCH = ["runner.batches", "runner.epoch_setup", "runner.buffers", "runner.replays",
               "runner.warmup", "runner.warmup", "runner.drain", "runner.capture",
               "runner.loss_read"]
GRAPH_EVAL = ["rank.embeddings", "setup.eval_plan", "setup.eval_plan", "setup.eval_plan",
              "rank.blocks", "rank.copy", "metrics.ids", "metrics.record"]
SEQ_EPOCH = ["runner.batches", "runner.buffers", "runner.replays", "runner.loss_read"]
SEQ_EVAL = ["rank.copy", "metrics.lists", "metrics.ids", "metrics.record"]


def test_graph_epoch_and_eval_record_their_spans_in_order(monkeypatch, tmp_path):
    """SimGCL through a fake graph (so that the warm-up, drain and capture
    run as on the card) then its eval: the runner's spans in the order the
    epoch runs them, then the ranking's and the metrics'. The plan, the
    mask and the device ground truth are built in the first eval only."""
    model = _simgcl()
    monkeypatch.setattr(model, "step_graph_eager_reason", lambda: None)
    monkeypatch.setattr(model, "graph_class", FakeGraph)
    with _cpu_profile() as prof:
        model.run_epoch(0)
        model.user_emb, model.item_emb = model.embeddings()
        model.fast_evaluation(0)
        model.user_emb, model.item_emb = model.embeddings()
        model.fast_evaluation(1)
    names = [r[0] for r in _ranges(prof, tmp_path)]
    second = [n for n in GRAPH_EVAL if n != "setup.eval_plan"]
    assert names == GRAPH_EPOCH + GRAPH_EVAL + second
    got = trace.totals(profiled=True)
    assert got["runner.warmup"].count == 2 and got["metrics.record"].count == 2
    assert model._graphs["train"].captures == 1


def test_sequential_epoch_and_eval_record_their_spans_in_order(tmp_path):
    model = _sasrec()
    with _cpu_profile() as prof:
        model.run_epoch(0)
        model.fast_evaluation(0)
    assert [r[0] for r in _ranges(prof, tmp_path)] == SEQ_EPOCH + SEQ_EVAL


@pytest.mark.parametrize("name", ["SimGCL", "SASRec"])
def test_the_eager_step_path_records_no_span_per_step(name):
    """On the CPU every step runs eagerly: a call of train_batches records
    the same spans for two steps as for all of them, and eager_batches
    (plain train_step after train_step) records none."""
    model = _simgcl() if name == "SimGCL" else _sasrec()
    batches = model.epoch_batches(0)
    counts = []
    for n in (2, batches[0].shape[0]):
        trace.reset()
        model.train_batches(*(b[:n] for b in batches))
        counts.append({k: v.count for k, v in trace.totals().items()})
    assert counts[0] == counts[1] == {"runner.buffers": 1, "runner.replays": 1}
    trace.reset()
    model.eager_batches(*batches)
    assert trace.totals() == {}


def test_profile_dir_trace_holds_the_program_spans(tmp_path):
    """The epoch ``profile.dir`` traces shows the runner's and the eval's
    spans as ranges of its Chrome trace."""
    model = _simgcl(**{"profile.dir": str(tmp_path / "trace")})
    model.train()
    (path,) = (tmp_path / "trace").iterdir()
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"runner.replays", "runner.loss_read", "rank.embeddings", "rank.blocks",
            "metrics.ids", "metrics.record"} <= names
    assert not any(n.startswith("setup.") for n in names)


# -- the step graph ---------------------------------------------------------------


def test_capture_ms_starts_after_the_drain(monkeypatch, tmp_path):
    """A slow drain (the warm-up steps still on the device) is timed in
    ``runner.drain``, not in ``capture_ms`` nor in ``runner.capture``."""
    drained = []

    def slow_drain(self):
        time.sleep(0.05)
        drained.append(time.perf_counter())

    monkeypatch.setattr(StepGraph, "_drain", slow_drain)
    trace.reset()
    graph = StepGraph(lambda: None, "cpu", "fake step", warmup=2, new_graph=FakeGraph)
    with _cpu_profile() as prof:
        for _ in range(4):
            graph()
    assert graph.captures == 1 and graph.replays == 2 and len(drained) == 1
    assert graph.capture_ms[0] < 50
    got = trace.totals(profiled=True)
    assert got["runner.drain"].host_s >= 0.05 and got["runner.capture"].host_s < 0.05
    assert got["runner.warmup"].count == 2
    ranges = {name: (a, b) for name, a, b in _ranges(prof, tmp_path)}
    assert ranges["runner.drain"][1] <= ranges["runner.capture"][0]


def test_float_operand_counts_no_launches():
    """K1's launches are counted by ``float_products`` and ``dual_matmul``;
    the operand pass has no counter of its own, and a replay adds to the
    counted wrappers only."""
    assert not hasattr(dense_dual.float_operand, "launches")
    assert cuda_graph.counted_wrappers()[:2] == (dense_dual.dual_matmul,
                                                 dense_dual.float_products)
    assert all(isinstance(w.launches, int) for w in cuda_graph.counted_wrappers())
    assert np.isfinite(dense_dual.float_operand_plain(
        torch.ones(5, 3), dense_dual.width_plan(3, 1)).float().numpy()).all()


@pytest.mark.cuda
def test_device_spans_time_the_card_and_stay_out_of_a_capture():
    """On the card: with no profiler a device span records nothing; under a
    CUDA profiler its events time its kernels; inside a stream capture it
    records none. Run with ``python -m pytest --noconftest -m cuda
    tests/test_torch_trace.py`` on a machine with the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    a = torch.randn(2048, 2048, device="cuda")
    trace.reset()
    with trace.device_span("rank.score", a.device):
        a @ a
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            with trace.device_span("rank.score", a.device):
                a @ a
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            a @ a
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            with trace.device_span("rank.topk", a.device):
                a @ a
        graph.replay()
        torch.cuda.synchronize()
    got = trace.totals(profiled=True)
    assert got["rank.score"].device_count == 3 and got["rank.score"].device_ms > 0
    assert "rank.topk" not in got
