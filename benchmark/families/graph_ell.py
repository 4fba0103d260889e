"""The graph trainer family on the row-split ELL layout: the program of
:mod:`benchmark.families.graph`, held to the path its cells exist for.

- At set-up it raises, naming what the program built, unless every
  adjacency the trainer holds (the model's, and a view template where the
  model keeps one, as SGL does) is an ``EllAdj`` and the negatives come
  from the CSR sampler (no rated bitmap).
- After the check steps and after every epoch it raises if K1 launched,
  or if, on the card, K2 did not launch twice a hop a step (one packed
  launch forward, one backward), by the launch counter.
- The traced run records the shape of each ``ell_gather.ell_gather_sum``
  call, eager and while a step graph is captured
  (:class:`benchmark.core.peaks_ell.K2Call`), and counts K2's launches
  from ``ell_gather_sum.launches``. The harness hands the family's
  ``k1_calls`` and ``kernel_launches()`` to the readers as the calls and
  launches of the kernel the family measures; here they are K2's, read by
  ``k2_roofline``.

Everything else (the data, the eval, the checks of the batches and
answers) is the graph family's."""

from __future__ import annotations

import torch

from benchmark.core.peaks_ell import K2Call
from benchmark.families import common, graph
from benchmark.families.graph import (SAMPLES, check_batches, eval_numbers,  # noqa: F401
                                      make_inputs, reference_answers, reference_batches)


def k2_launches() -> int:
    """K2's launches so far, replays included."""
    from selfrec_tpu_torch.ops import ell_gather

    return ell_gather.ell_gather_sum.launches


def _built(model) -> str:
    layouts = [type(model.adj).__name__]
    if hasattr(model, "_view_template"):
        layouts.append(f"view template {type(model._view_template).__name__}")
    sampler = "CSR" if model._rated_bitmap is None else "bitmap"
    return f"{', '.join(layouts)} and the {sampler} sampler"


class Program(graph.Program):
    def __init__(self, cfg: dict, conf: dict, inputs: dict, device, spans):
        super().__init__(cfg, conf, inputs, device, spans)
        from selfrec_tpu_torch.ops.spmm_ell import EllAdj

        m = self.model
        layouts = [m.adj] + ([m._view_template] if hasattr(m, "_view_template") else [])
        if not all(isinstance(a, EllAdj) for a in layouts) or m._rated_bitmap is not None:
            raise RuntimeError(f"{cfg['name']} measures the ELL layout and the CSR sampler; "
                               f"the program built {_built(m)}")

    def _held_to_path(self, k1_before: int, k2_before: int, n_steps: int, what: str):
        k1 = common.k1_launches() - k1_before
        k2 = k2_launches() - k2_before
        if k1:
            raise RuntimeError(f"{what}: K1 launched {k1} times on the ELL path")
        want = 2 * self.model.n_layers * n_steps
        if self.device.type == "cuda" and k2 != want:
            raise RuntimeError(f"{what}: K2 launched {k2} times in {n_steps} steps, "
                               f"not {want} (one packed launch a hop forward and one backward)")

    def check_steps(self, n_steps: int, params0) -> dict:
        before = common.k1_launches(), k2_launches()
        out = super().check_steps(n_steps, params0)
        self._held_to_path(*before, n_steps, "the check steps")
        return out

    def train_epoch(self, epoch: int):
        before = common.k1_launches(), k2_launches()
        losses = super().train_epoch(epoch)
        self._held_to_path(*before, len(losses), f"epoch {epoch}")
        return losses

    def trace_spans(self):
        from selfrec_tpu_torch.ops import ell_gather, spmm_ell

        super().trace_spans()
        self.k1_calls = []  # K2's calls, under the name the harness reads
        record = self.k1_calls.append
        fn = ell_gather.ell_gather_sum

        def counted(layout, w, x, _fn=fn):
            p, v, k = w.shape
            n_long = layout.long_rows.shape[0]
            record(K2Call(v, k, p, x.shape[1] // p, str(x.dtype).split(".")[-1], layout.n_rows,
                          layout.n_src, layout.item_dst.shape[0] - (layout.n_rows - n_long),
                          x.is_cuda and torch.cuda.is_current_stream_capturing()))
            return _fn(layout, w, x)

        def undo():
            # the kernel's wrapper counts its launches on whatever the
            # module's name holds
            fn.launches = ell_gather.ell_gather_sum.launches
            ell_gather.ell_gather_sum = spmm_ell.ell_gather_sum = fn

        counted.launches = fn.launches
        ell_gather.ell_gather_sum = spmm_ell.ell_gather_sum = counted
        self.spans.on_close(undo)

    kernel_launches = staticmethod(k2_launches)
