"""k1_roofline: K1's least time (benchmark/core/peaks.py
``k1_bound_s``, from the shapes of the calls the steps made) over its
device time in the traced epochs, summed over its kernels
(``dual_float_kernel``, ``float_operand_kernel``, ``dual_s8_kernel``).

The shapes come from the harness's wrapper around
``dense_dual.float_products`` and ``dense_dual.dual_matmul`` (int8): the
eager steps' calls each once, and the calls recorded while a step graph
was being captured once a replay, the number of replays being the
program's launch count less the eager calls, over the calls a capture
holds."""

from benchmark.core.peaks import k1_bound_s

KERNELS = ("dual_float_kernel", "float_operand_kernel", "dual_s8_kernel")


def read(run):
    tr, calls = run.trace, run.k1_calls
    if not tr or not tr.get("busy_s") or not calls or not run.rec["epochs"]:
        return None
    device_s = sum(t for name, t in tr["kernels"].items() if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    eager = [c for c in calls if not c[4]]
    captured = [c for c in calls if c[4]]
    bound = lambda cs: sum(k1_bound_s(u, i, w, dt) for u, i, w, dt, _ in cs)
    replays = (run.k1_launches - len(eager)) / len(captured) if captured else 0
    return 100.0 * (bound(eager) + replays * bound(captured)) / device_s
