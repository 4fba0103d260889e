"""train.runner_idle_ms.seq: ms a traced sequential-trainer epoch leaves the
card idle inside the program's trainer runner: the idle gaps of the
profiler's trace whose innermost span is a ``runner.*`` span
(``breakdown.idle_gaps``: epoch_batches, the step buffers, the warm-up
steps, the drain, the capture, the replay loop, the loss read), over the
traced epochs. None on the CPU and where the program records no runner
span."""


def read(run):
    tr = run.trace
    if not tr or run.family.SAMPLES != "seqs" or not run.rec["epochs"] or not tr.get("busy_s"):
        return None
    try:
        from selfrec_tpu_torch.utils import trace
    except ImportError:
        return None
    if not any(n.startswith("runner.") for n in trace.totals(profiled=True)):
        return None
    idle = sum(s for n, s in tr["breakdown"]["idle_gaps"] if n.startswith("runner."))
    return 1e3 * idle / run.rec["epochs"]
