"""setup.data_s: seconds of set-up the program spends on its host data,
from the ``setup.data`` span (selfrec_tpu_torch/utils/trace.py): the
trainer's Interaction or Sequence built from the harness's arrays, and the
sequential trainer's padded windows. Program spans recorded before the
profiler started; None where the program records no span."""


def read(run):
    try:
        from selfrec_tpu_torch.utils import trace
    except ImportError:
        return None
    t = trace.totals(profiled=False).get("setup.data")
    return t.host_s if t is not None and t.count else None
