"""The per-layer metrics that read the program's own spans
(selfrec_tpu_torch/utils/trace.py), in a traced run of each cell at a
small size on the CPU: the set-up readers report seconds, the readers of
device time report nothing (there is no card), and the program's spans
reach the trace's idle gaps."""

import importlib.util
import os
import sys
import time

import pytest

from _small import LISTED, SEED, small
from benchmark.core import harness, registry
from benchmark.core import trace as bench_trace

SETUP = ("setup.data_s", "setup.device_build_s")
DEVICE = ("train.runner_idle_ms.graph", "train.runner_idle_ms.seq", "eval.topk_ms",
          "eval.score_ms")
PROGRAM = ("setup.", "runner.", "rank.", "metrics.")


def _reader(name):
    path = os.path.join(registry.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"program_span_reader_{len(name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


READ = {name: _reader(name) for name in SETUP + DEVICE}


@pytest.mark.parametrize("cell", LISTED)
def test_traced_run_reads_the_program_spans(cell, monkeypatch):
    """Every host op counts as device work here, so that the idle gaps are
    the host's pure Python stretches, each put down to its innermost span:
    the program's spans hold some, and the runner's idle is read from them."""
    monkeypatch.setattr(bench_trace, "DEVICE_CATS", bench_trace.DEVICE_CATS + ("cpu_op",))
    out = harness.run(cell, SEED, 0.2, True, "cpu", time.perf_counter(), overrides=small(cell))
    assert out["correct"] is True
    metrics = out["metrics"]
    assert {m["name"] for m in registry.cell(cell).per_layer} >= set(SETUP)
    for name in SETUP:
        assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "s"
    assert metrics["setup.data_s"]["value"] + metrics["setup.device_build_s"]["value"] < \
        out["samples"]["setup_s"]
    holders = [name for name, _ in out["breakdown"]["idle_gaps"]]
    assert any(name.startswith(PROGRAM) for name in holders), holders
    runner = [n for n in DEVICE if n.startswith("train.") and n in metrics]
    if cell.endswith(".train"):
        assert len(runner) == 1 and metrics[runner[0]]["value"] >= 0
        assert metrics[runner[0]]["unit"] == "ms/epoch"
    else:
        assert not runner
    # the eval's device spans are CUDA events: none on the CPU
    assert "eval.topk_ms" not in metrics and "eval.score_ms" not in metrics


@pytest.mark.parametrize("cell", LISTED)
def test_device_readers_and_a_program_without_spans_give_none(cell, monkeypatch):
    """On the CPU the readers of device time find nothing; and a program
    that records no span of its own (one without
    selfrec_tpu_torch/utils/trace.py) gives every new reader nothing, even
    where a card was busy: each returns None and none raises."""
    out = {}

    def keep(ctx):
        out["ctx"] = ctx
        return None

    monkeypatch.setattr(registry, "reader", lambda name: keep)
    harness.run(cell, SEED, 0.0, True, "cpu", time.perf_counter(), overrides=small(cell))
    ctx = out["ctx"]
    for name in DEVICE:
        assert READ[name](ctx) is None, name
    assert READ["setup.data_s"](ctx) > 0
    ctx.trace = dict(ctx.trace, busy_s=1.0)
    monkeypatch.setitem(sys.modules, "selfrec_tpu_torch.utils.trace", None)
    monkeypatch.delattr(sys.modules["selfrec_tpu_torch.utils"], "trace")
    for name in SETUP + DEVICE:
        assert READ[name](ctx) is None, name
