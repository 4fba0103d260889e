"""device.idle_share.train_seq: the share of the traced window, whole
sequential-trainer epochs, in which no kernel, copy or memset ran on the
card. From the profiler's trace (union of device intervals)."""


def read(run):
    tr = run.trace
    if not tr or run.family.SAMPLES != "seqs" or not run.rec["epochs"] or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
