"""Spans that the harness puts around the calls into each layer, and the
reading of the profiler's device trace.

A span is recorded on the host clock and, under the profiler, as a
``record_function`` range, so that it shows in the trace on the clock of
the device's kernels. Spans are only put in the traced run (``--trace
1``), by wrapping the entry functions of the layers; the runs that give
the end-to-end metrics carry none.

The device trace is read from ``torch.profiler``'s Chrome trace: the
device is busy where any kernel, copy or memset runs (the union of their
intervals), idle elsewhere inside the traced window; each idle gap is put
down to the innermost span that holds its middle."""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"


class Spans:
    """Host-clock spans by name, and the wrappers that record them."""

    def __init__(self, profiled: bool):
        self.profiled = profiled
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self._undo: List[Callable[[], None]] = []

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        ctx = torch.profiler.record_function(name) if self.profiled else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
            if sync is not None:
                torch.cuda.synchronize(sync)
        self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self.total[name] += seconds
        self.count[name] += 1

    def wrap(self, owner, attr: str, name: str, sync=None):
        """Record span ``name`` around every call of ``owner.attr`` until
        :meth:`close`; with ``sync`` (a device) the span ends in a
        synchronise."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self.span(name, sync):
                return fn(*args, **kwargs)

        self.patch(owner, attr, wrapped)

    def patch(self, owner, attr: str, value):
        had = attr in vars(owner)
        old = vars(owner).get(attr)
        setattr(owner, attr, value)
        self._undo.append(lambda: setattr(owner, attr, old) if had else delattr(owner, attr))

    def on_close(self, undo: Callable[[], None]):
        self._undo.append(undo)

    def close(self):
        while self._undo:
            self._undo.pop()()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read_trace(path: str, top: int = 10) -> Optional[dict]:
    """Busy and window seconds, kernel time by name, and the longest idle
    gaps by host span, from a Chrome trace whose window is the
    ``record_function`` range named ``window``. None when the trace holds
    no window."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            dev.append((a, b, e.get("name", "?"), cat))
        elif cat == "user_annotation":
            if e.get("name") == WINDOW:
                window = (a, b)
            else:
                spans.append((a, b, e.get("name", "?")))
    if window is None:
        return None
    w0, w1 = window
    busy = _merge([(max(a, w0), min(b, w1)) for a, b, _, _ in dev if b > w0 and a < w1])
    by_name: Dict[str, float] = defaultdict(float)
    kernels: Dict[str, float] = defaultdict(float)
    for a, b, name, cat in dev:
        by_name[name[:120]] += b - a
        if cat == "kernel":
            kernels[name] += b - a
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    spans.sort(key=lambda s: s[1] - s[0])
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        holder = next((n for s0, s1, n in spans if s0 <= mid <= s1), "harness loop")
        gaps[holder] += b - a
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": sum(b - a for a, b in busy), "window_s": w1 - w0,
            "kernels": dict(kernels),
            "breakdown": {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}}


@contextlib.contextmanager
def profiled_window(path: str, device):
    """Profile the block as the window (the card's activity too on CUDA);
    yields a dict that holds the read trace once the block has ended. The
    trace file is removed after it is read."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    out: dict = {}
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    sync()
    prof.start()
    try:
        with torch.profiler.record_function(WINDOW):
            yield out
            sync()
    finally:
        prof.stop()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        out.update(read_trace(path) or {})
    finally:
        os.remove(path)
