"""setup.device_build_s: seconds of set-up the program spends building what
it holds on the device, from its spans (selfrec_tpu_torch/utils/trace.py):
``setup.adj`` (the adjacency: dense block, kept transpose or ELL layout,
and its upload), ``setup.sampler`` (the rated CSR and the negatives'
bitmap), ``setup.params`` (init_params, set_params, the optimizer) and
``setup.eval_plan`` (the eval plan and rated mask, once). Program spans
recorded before the profiler started; None where the program records
none."""

NAMES = ("setup.adj", "setup.sampler", "setup.params", "setup.eval_plan")


def read(run):
    try:
        from selfrec_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.totals(profiled=False)
    found = [spans[n].host_s for n in NAMES if n in spans and spans[n].count]
    return sum(found) if found else None
