"""eval.topk_ms: device ms an eval spends in the top-k of its score
blocks: the ``rank.topk`` device spans (CUDA events around each block's
``torch.topk`` in ops/ranking.py, recorded while the profiler runs) over
the traced evals. None on the CPU and where the program records none."""


def read(run):
    n = len(run.rec["evals_s"])
    if not run.trace or not n:
        return None
    try:
        from selfrec_tpu_torch.utils import trace
    except ImportError:
        return None
    t = trace.totals(profiled=True).get("rank.topk")
    return t.device_ms / n if t is not None and t.device_count else None
