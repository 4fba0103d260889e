"""Small sizes at which every cell runs on the CPU in seconds, and the
cells the tests drive: those of BENCHMARK.json, and SASRec's full eval,
whose configuration, traffic and family code are in the benchmark though
BENCHMARK.json does not list the cell (its host-bound runs spread too
widely to hold a bound; see PERF.md)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.core import registry  # noqa: E402

SMALL = {"SimGCL-yelp2018": {"users": 300, "items": 400, "interactions": 6000,
                             "batch.size": 128},
         "SASRec-amazon-beauty": {"sequences": 600, "items": 300, "batch.size": 64,
                                  "max.len": 20}}
LISTED = ["SimGCL-yelp2018.train", "SASRec-amazon-beauty.train", "SimGCL-yelp2018.eval"]
CELLS = LISTED + ["SASRec-amazon-beauty.eval"]
SEED = 2**31 + 12345


def small(cell: str) -> dict:
    return SMALL[cell.rsplit(".", 1)[0]]


def cell_of(name: str):
    """The workload's name where BENCHMARK.json lists it, else the cell
    put together from its configuration and traffic files."""
    if name in LISTED:
        return name
    spec = registry.spec()
    e2e = [m for m in spec["end_to_end"] if m["name"] in ("eval_ms", "setup_s")]
    layer = [m for m in spec["per_layer"]
             if m["name"] in ("eval.rank_ms", "eval.host_ms", "device.idle_share.eval")]
    return registry.Cell(name, registry.configuration("SASRec-amazon-beauty"),
                         registry.traffic("full_eval"), 1, e2e, layer)
