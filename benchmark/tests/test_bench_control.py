"""The control of every cell, on the card at the cell's own size: the
configuration's next lower precision (SimGCL's int8 operands, the
reference in TF32 for SASRec) put in the program's place fails the check,
and so does each fault planted in the reference put in the program's
place. Needs an NVIDIA card and nvcc; skips where there is none."""

import time

import pytest
import torch

from _small import LISTED, SEED
from benchmark.core import harness, registry
from benchmark.reference import judge


def _held(numbers, limits):
    return {k: [numbers[k], lim] for k, lim in limits.items() if k in numbers}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", LISTED)
def test_control_fails_the_check(cell, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = registry.cell(cell).config
    for key, value in cfg["control"].get("env", {}).items():
        monkeypatch.setenv(key, value)
    out = harness.run(cell, SEED, 1.0, False, "cuda", time.perf_counter(), control=True)
    limits = cfg["limits"]["train" if cell.endswith(".train") else "eval"]
    ctl = out["control"]
    lower = out["checks"] if cfg["control"].get("env") else _held(ctl["control"], limits)
    assert not judge.passed(lower)
    for fault in ("half_batch", "answer_altered"):
        if fault in ctl:
            assert not judge.passed(_held(ctl[fault], limits)), fault
    if "state_unchanged" in ctl:
        assert ctl["state_unchanged"]["delta_gap"] > limits["delta_gap"]
