"""Every cell end to end at a small size on the CPU, through the same
traffic files, families and references as on the card: the last line is
the contract's shape, the reference agrees with the port, and the traced
run reads its spans."""

import io
import json
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from _small import CELLS, SEED, cell_of, small
from benchmark import run as bench
from benchmark.core import harness, registry


def _line(out: dict):
    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        bench.report(out)
    lines = buf.getvalue().strip().splitlines()
    assert lines[0].startswith("[samples] ")
    return json.loads(lines[-1]), err.getvalue().strip().splitlines()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end_on_the_cpu(cell):
    out = harness.run(cell_of(cell), SEED, 0.3, False, "cpu", time.perf_counter(),
                      overrides=small(cell))
    line, err = _line(out)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    c = cell_of(cell)
    want = {m["name"] for m in (registry.cell(c) if isinstance(c, str) else c).end_to_end}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert len(err) == len(line["checks"]) and all(e.startswith("[check] ") for e in err)
    for number, limit in line["checks"].values():
        assert number <= limit


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_at_small_size(cell):
    """On the CPU the port takes its plain f32 paths, so every gap is
    round-off: far under any limit, and the exact comparisons exact."""
    out = harness.run(cell_of(cell), SEED + 1, 0.0, False, "cpu", time.perf_counter(),
                      overrides=small(cell))
    for name, (number, _) in out["checks"].items():
        assert number < 1e-4, (name, number)


@pytest.mark.parametrize("cell", ["SimGCL-yelp2018.eval", "SASRec-amazon-beauty.train"])
def test_traced_run_reads_spans_and_breakdown(cell):
    out = harness.run(cell, SEED, 0.2, True, "cpu", time.perf_counter(), overrides=small(cell))
    assert out["correct"] is True
    assert "busy_s" in out["device"] and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU run reads no device time, so no device metric; host spans it reads
    names = set(out["metrics"])
    assert not any(n.startswith(("device.", "train.mfu", "k1.")) for n in names)
    if cell.endswith(".eval"):
        assert {"eval.rank_ms", "eval.host_ms"} <= names


def test_same_seed_same_inputs():
    cfg = registry.cell("SimGCL-yelp2018.train").config
    fam = registry.module("families", cfg["family"])
    data = dict(cfg["data"], **{k: v for k, v in small("SimGCL-yelp2018.train").items()
                                if k in cfg["data"]})
    a = fam.make_inputs(data, harness.seeds(SEED)[0])
    b = fam.make_inputs(data, harness.seeds(SEED)[0])
    assert all((a[k] == b[k]).all() for k in ("train_u", "train_i", "test_u", "test_i"))
