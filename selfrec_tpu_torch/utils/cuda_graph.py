"""CUDA graphs of the trainers' step and of the sequential eval's block: the
port's counterpart of the JAX package's one-dispatch epoch and scanned eval
(``selfrec_tpu/models/base.py``: ``_epoch_fn`` :500-556 runs the epoch as
one jitted ``lax.scan``, the sequential trainer :860-891 likewise, and
``_test_scan_jit`` :733-759 all eval blocks in one dispatch).

A :class:`StepGraph` holds a callable that reads and writes only tensors
that outlive it (params, Adam's state, persistent batch buffers and a
device step counter). On the card its first ``warmup`` calls run eagerly on
a side stream, as ``torch.cuda.graphs`` asks; they are real steps, not
thrown away. The next call captures the callable into a
``torch.cuda.CUDAGraph`` (capture runs no work) and replays it, and every
later call replays it: one graph launch a step instead of hundreds of
kernel launches from Python. Where the trainer gives it no graph to capture
into (the CPU, a mesh), every call runs the same callable eagerly.

- **Random draws.** The generators the callable draws from are registered
  with the graph, so that each replay advances their Philox offset as an
  eager step does: replays draw new numbers, the same ones the eager steps
  would.
- **Launch counts.** The kernel wrappers count launches in Python, which a
  replay does not run. The graph records each counter's increments during
  its capture and adds them again on every replay, so a count stays the
  number of launches that ran.
- **Addresses.** A replay reads the tensors the capture saw. K1 bakes
  the tensor maps of B, its kept transpose and its operands into the
  graph (``csrc/dense_dual.cu`` encodes them at launch): B and Bᵀ are the
  model's, or the epoch's view's, and every epoch captures again; the
  operands and every activation come from the graph's memory pool. K2's partial buffer is made in the warm-up. Params, Adam's
  state and aux are written in place (``set_params``, a resume,
  ``write_aux``).
- **A failed capture raises**, naming the graph and the op of the port
  that failed; there is no quiet fall back to eager steps.
- **Spans** (:mod:`selfrec_tpu_torch.utils.trace`): each warm-up step
  is ``runner.warmup``; before a capture, ``runner.drain`` waits for the
  work queued so far (the warm-up steps, the epoch's batches), so that
  ``runner.capture`` and ``capture_ms`` time the capture alone, with the
  cache flush ``torch.cuda.graph`` makes on entry.
- :meth:`StepGraph.close` frees the graph and its memory pool.
"""

from __future__ import annotations

import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch

from selfrec_tpu_torch.utils import trace


def counted_wrappers():
    """The kernel wrappers whose ``launches`` a replay must add to."""
    from selfrec_tpu_torch.ops import dense_dual, ell_gather

    return dense_dual.dual_matmul, dense_dual.float_products, ell_gather.ell_gather_sum


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` behind the three calls :class:`StepGraph`
    makes: capture a callable, replay, reset."""

    def __init__(self, generators: Sequence[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)

    def capture(self, fn: Callable[[], object]) -> None:
        with torch.cuda.graph(self.graph):
            fn()

    def replay(self) -> None:
        self.graph.replay()

    def reset(self) -> None:
        self.graph.reset()


def _failing_op(exc: BaseException) -> str:
    """The innermost frame of the port in the traceback of ``exc`` or of
    the exception it was raised in (``capture_end`` raises again after a
    failed op), as ``file:line code``: the op a capture failed in."""
    while exc is not None:
        frames = [f for f in traceback.extract_tb(exc.__traceback__)
                  if "selfrec_tpu_torch" in f.filename
                  and not f.filename.endswith("cuda_graph.py")]
        if frames:
            f = frames[-1]
            return (f"{f.filename.split('selfrec_tpu_torch', 1)[1].lstrip('/')}:"
                    f"{f.lineno} {f.line}")
        exc = exc.__context__
    return "an op outside the port"


class StepGraph:
    """``fn`` run as a captured graph, or eagerly.

    ``name`` names the graph in its log lines and errors; ``new_graph``
    makes the graph object (a :class:`CudaGraph` over the generators ``fn``
    draws from; tests pass a fake one), and without it every call runs
    ``fn`` eagerly."""

    def __init__(self, fn: Callable[[], object], device, name: str, warmup: int = 2,
                 new_graph: Optional[Callable[[], object]] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self.warmup = warmup
        self.new_graph = new_graph
        self.graph = None
        self.warmup_left = warmup
        self.captures = 0
        self.replays = 0
        self.capture_ms: List[float] = []
        self._delta = ()
        self._inputs = ()

    @property
    def graphed(self) -> bool:
        return self.new_graph is not None

    def __call__(self) -> None:
        if not self.graphed:
            self.fn()
        elif self.graph is None and self.warmup_left > 0:
            self.warmup_left -= 1
            self._warm()
        else:
            if self.graph is None:
                self._capture()
            self._replay()

    @trace.span("runner.warmup")
    def _warm(self) -> None:
        if self.device.type != "cuda":
            self.fn()
            return
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.fn()
        main.wait_stream(side)

    def _drain(self) -> None:
        """Wait for the work queued before the capture."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _capture(self) -> None:
        wrappers = counted_wrappers()
        before = [w.launches for w in wrappers]
        graph = self.new_graph()
        with trace.span("runner.drain"):
            self._drain()
        with trace.span("runner.capture"):
            t0 = time.perf_counter()
            try:
                graph.capture(self.fn)
            except RuntimeError as exc:
                raise RuntimeError(f"[graph] {self.name}: capture failed in "
                                   f"{_failing_op(exc)}: {exc}") from exc
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.capture_ms.append(1e3 * (time.perf_counter() - t0))
        # capture ran no kernel: take its counts back, add them per replay
        self._delta = tuple(w.launches - b for w, b in zip(wrappers, before))
        for w, b in zip(wrappers, before):
            w.launches = b
        self.graph = graph
        self.captures += 1
        print(f"[graph] {self.name}: captured (capture {self.captures}, "
              f"{self.capture_ms[-1]:.1f} ms)", flush=True)

    def _replay(self) -> None:
        try:
            self.graph.replay()
        except RuntimeError as exc:
            raise RuntimeError(f"[graph] {self.name}: replay failed: {exc}") from exc
        for w, d in zip(counted_wrappers(), self._delta):
            w.launches += d
        self.replays += 1

    def track(self, *inputs) -> None:
        """Hold the objects ``fn`` reads that a caller may replace (the
        optimizer, the aux dict, the params dict): when one is not the
        object held, the graph is dropped and the next call warms up and
        captures again."""
        if len(inputs) != len(self._inputs) or any(
                a is not b for a, b in zip(inputs, self._inputs)):
            if self._inputs:
                self.invalidate(warm=True)
            self._inputs = inputs

    def invalidate(self, warm: bool) -> None:
        """Drop the captured graph, so that the next call captures again;
        with ``warm`` the next ``warmup`` calls run eagerly first (a new
        optimizer or new per-epoch state: lazy state is made outside the
        capture)."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
        if warm:
            self.warmup_left = self.warmup

    def close(self) -> None:
        """Free the graph; its memory pool goes once the tensors it holds
        are dropped."""
        self.invalidate(warm=True)
        self.fn = None
        self._inputs = ()
