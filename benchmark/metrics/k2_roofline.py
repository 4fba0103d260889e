"""k2_roofline: K2's least time (benchmark/core/peaks_ell.py ``k2_bound_s``,
from the shapes of the calls the steps made) over its device time in the
traced epochs, summed over its kernels (``ell_items_kernel``,
``ell_long_rows_kernel``).

The shapes come from the ELL family's wrapper around
``ell_gather.ell_gather_sum``, which the harness hands over as the
family's kernel calls: the eager steps' calls each once, and the calls
recorded while a step graph was being captured once a replay, the number
of replays being the launch count less the eager calls, over the calls a
capture holds. None where the family records no K2 call or the trace holds
no K2 kernel."""

from benchmark.core.peaks_ell import K2Call, k2_bound_s

KERNELS = ("ell_items_kernel", "ell_long_rows_kernel")


def read(run):
    tr = run.trace
    calls = [c for c in run.k1_calls if isinstance(c, K2Call)]
    if not tr or not tr.get("busy_s") or not calls or not run.rec["epochs"]:
        return None
    device_s = sum(t for name, t in tr["kernels"].items() if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    eager = [c for c in calls if not c.capturing]
    captured = [c for c in calls if c.capturing]
    bound = lambda cs: sum(k2_bound_s(c) for c in cs)
    replays = (run.k1_launches - len(eager)) / len(captured) if captured else 0
    return 100.0 * (bound(eager) + replays * bound(captured)) / device_s
