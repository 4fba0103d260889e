"""train.mfu.graph: the graph trainer's model FLOP rate over whole traced
epochs, as a share of the card's peak in the configuration's precision
(benchmark/core/peaks.py). The step's FLOPs come from the configuration's
reference (``step_flops``), independent of layout; the time is the traced
window, per-epoch set-up and captures included."""

from benchmark.core.peaks import PEAK


def read(run):
    tr = run.trace
    if not tr or run.family.SAMPLES != "pairs" or not run.rec["steps"] or not tr.get("busy_s"):
        return None
    flops = run.reference.step_flops(run.inputs, run.conf) * run.rec["steps"]
    return 100.0 * flops / (tr["window_s"] * PEAK[run.cfg["precision"]])
