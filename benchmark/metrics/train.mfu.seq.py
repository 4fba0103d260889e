"""train.mfu.seq: the sequential trainer's model FLOP rate over whole
traced epochs, as a share of the card's peak in the configuration's
precision (float32 outside the tensor cores for SASRec). FLOPs from the
configuration's reference (``step_flops``); time the traced window."""

from benchmark.core.peaks import PEAK


def read(run):
    tr = run.trace
    if not tr or run.family.SAMPLES != "seqs" or not run.rec["steps"] or not tr.get("busy_s"):
        return None
    flops = run.reference.step_flops(run.inputs, run.conf) * run.rec["steps"]
    return 100.0 * flops / (tr["window_s"] * PEAK[run.cfg["precision"]])
