"""train.views_ms.sgl: ms a traced epoch spends making its two dropped
views (SGL's ``epoch_setup``): the host ms of the program's ``views.keep``
spans (the keep masks drawn and copied to the card) and the device ms of
its ``views.weights`` device spans (the views' weights renormalized on the
card), from ``selfrec_tpu_torch/utils/trace.py``'s totals of the traced
window, over the traced epochs. None on the CPU, where no device span is
recorded, and where the program records no view span."""


def read(run):
    if not run.trace or not run.rec["epochs"]:
        return None
    try:
        from selfrec_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.totals(profiled=True)
    keep, weights = spans.get("views.keep"), spans.get("views.weights")
    if keep is None or weights is None or not weights.device_count:
        return None
    return (1e3 * keep.host_s + weights.device_ms) / run.rec["epochs"]
