"""Everything of a cell found by name: ``BENCHMARK.json`` at the root of
the checkout names the cells, configurations and metrics; each
configuration is ``configs/<name>.json``, each traffic mix
``traffic/<name>.json``, each metric's reader ``metrics/<name>.py``, each
trainer family ``families/<name>.py`` and each plain reference
``reference/<name>.py``, all under this folder. A later cell, mix or metric
is added by adding files and entries, without editing these."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, its
    traffic and the metrics it reports: the end-to-end metrics that list it
    (or list no cells), and the per-layer metrics that list it, or list no
    cells and move an end-to-end metric it reports."""
    s = spec(root)
    work = {w["name"]: w for w in s["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(work)}")
    w = work[name]
    conf = next(c for c in s["configs"] if c["name"] == w["config"])
    e2e = [m for m in s["end_to_end"] if _listed(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in s["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, _json(os.path.join(root, conf["file"])), traffic(w["traffic"]),
                int(w["chips"]), e2e, layer)


def configuration(name: str, root: str = ROOT) -> dict:
    """The configuration file of the configuration ``name``."""
    conf = next(c for c in spec(root)["configs"] if c["name"] == name)
    return _json(os.path.join(root, conf["file"]))


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def module(kind: str, name: str):
    """``families.<name>`` or ``reference.<name>`` of this folder."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


_readers: Dict[str, object] = {}


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    fn = _readers.get(metric)
    if fn is None:
        path = os.path.join(HERE, "metrics", f"{metric}.py")
        sp = importlib.util.spec_from_file_location(f"benchmark_metric_{len(_readers)}", path)
        mod = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(mod)
        fn = _readers[metric] = mod.read
    return fn
