"""BENCHMARK.json against the benchmark's contract, and the registry that
finds each configuration, traffic mix and metric reader by name."""

import json
import os
import re

import pytest

from _small import LISTED, ROOT
from benchmark.core import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return registry.spec()


def test_top_level_keys_and_size(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51


def test_names_units_and_lines(spec):
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in spec["workloads"]]:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in spec["configs"]] + [w["why"] for w in spec["workloads"]]
                 + [m["layer"] for m in spec["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_exactly_their_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(spec):
    assert [w["name"] for w in spec["workloads"]] == LISTED
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for name in LISTED:
        cell = registry.cell(name)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or name in moved["workloads"]


def test_registry_finds_files_by_name(spec):
    for name in LISTED:
        cell = registry.cell(name)
        assert cell.config["name"] == name.rsplit(".", 1)[0]
        assert {"train_epochs", "evals", "check_steps", "warm_evals"} <= set(cell.traffic)
        registry.module("families", cell.config["family"])
        ref = registry.module("reference", cell.config["reference"])
        assert callable(ref.make_params) and callable(ref.step_flops)
        lim = cell.config["limits"]
        assert set(lim) == {"train", "eval"}
        assert set(lim["train"]) == {"loss_gap", "grad_gap", "delta_gap", "batch_bad"}
        assert {"rank_gap", "rank_bad", "metric_gap"} <= set(lim["eval"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(registry.reader(m["name"]))
    with pytest.raises(KeyError):
        registry.cell("no-such-cell")


def test_configuration_files_state_their_source(spec):
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] and conf["assumed"]
