"""eval_ms_p95: the 95th percentile (nearest rank) of all evals in the
window, in ms. Host clock."""

import math


def read(run):
    evals = sorted(run.rec["evals_s"])
    if not evals:
        return None
    return 1e3 * evals[math.ceil(0.95 * len(evals)) - 1]
