"""The port's spans: host-clock totals of set-up, of the trainer runner and
of the eval, and the device time of the eval's ranking phases.

- :func:`span` always adds its host seconds and a count to the record, and
  notes whether a ``torch.profiler`` was recording when it began. While
  one records (the benchmark's traced window, ``profile.dir``'s epoch) the
  span is also a ``record_function`` range, so the profiler's trace shows
  it on the clock of the device's kernels. A span inside an open span of
  the same name adds nothing: the outer one counts.
- :func:`device_span` records a pair of CUDA events on the device's
  current stream while a profiler records and the work runs on the card,
  outside a stream capture; the pairs are resolved only when read, after
  the caller's synchronise. Anywhere else it does nothing.
- :func:`count` adds one to a named counter of what set-up built (the
  adjacency's layout, the negatives' sampler); :func:`counts` reads them.
- :func:`reset` starts a fresh record (every recommender's constructor
  calls it, so a run reads only its own spans); :func:`totals` reads it.

Spans sit at set-up, epoch and eval granularity only: none runs inside a
step or anything a CUDA graph captures, so a replay runs no Python and an
eager step pays no span. The profiler is the only switch.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or the autograd profiler) records."""
    return bool(torch.autograd.profiler._is_profiler_enabled)


@dataclass
class Totals:
    """One span name's totals: host seconds and count; device ms and count
    of its device spans."""

    host_s: float = 0.0
    count: int = 0
    device_ms: float = 0.0
    device_count: int = 0


class _Record:
    def __init__(self):
        self.host: Dict[Tuple[str, bool], float] = defaultdict(float)
        self.count: Dict[Tuple[str, bool], int] = defaultdict(int)
        self.pending: Dict[str, List[tuple]] = defaultdict(list)
        self.device_ms: Dict[str, float] = defaultdict(float)
        self.device_count: Dict[str, int] = defaultdict(int)
        self.counts: Dict[str, int] = defaultdict(int)
        self.open: set = set()


_record = _Record()


def reset() -> None:
    """Start a fresh record; spans still open finish into the old one."""
    global _record
    _record = _Record()


@contextlib.contextmanager
def span(name: str):
    """Host seconds and a count for ``name``; under a profiler also a
    ``record_function`` range. Usable as a decorator."""
    rec = _record
    if name in rec.open:
        yield
        return
    profiled = profiling()
    rec.open.add(name)
    t0 = time.perf_counter()
    try:
        if profiled:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        rec.open.discard(name)
        rec.host[name, profiled] += time.perf_counter() - t0
        rec.count[name, profiled] += 1


def device_span(name: str, device):
    """CUDA events around the block on ``device``'s current stream, while a
    profiler records and no stream is being captured; a shared null
    context otherwise."""
    if not profiling():
        return _OFF
    device = torch.device(device)
    if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return _OFF
    return _device_span(name, device)


@contextlib.contextmanager
def _device_span(name: str, device: torch.device):
    stream = torch.cuda.current_stream(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end.record(stream)
    _record.pending[name].append((start, end))


def count(name: str) -> None:
    """One more of ``name`` in the record's counters (``layout.EllAdj``,
    ``sampler.csr``): no time, no range."""
    _record.counts[name] += 1


def counts() -> Dict[str, int]:
    """The current record's counters."""
    return dict(_record.counts)


def _resolve(rec: _Record) -> None:
    for name, pairs in rec.pending.items():
        for start, end in pairs:
            end.synchronize()
            rec.device_ms[name] += start.elapsed_time(end)
            rec.device_count[name] += 1
        pairs.clear()


def totals(profiled: Optional[bool] = None) -> Dict[str, Totals]:
    """Each span name's totals in the current record: the host spans begun
    while a profiler recorded (``profiled=True``), while none did
    (``False``), or both (``None``); device spans, which only a profiler's
    run records, unless ``profiled`` is False. Pending device spans are
    resolved first."""
    rec = _record
    out: Dict[str, Totals] = defaultdict(Totals)
    for (name, on), seconds in rec.host.items():
        if profiled is None or on == profiled:
            out[name].host_s += seconds
            out[name].count += rec.count[name, on]
    if profiled is not False:
        _resolve(rec)
        for name, ms in rec.device_ms.items():
            out[name].device_ms += ms
            out[name].device_count += rec.device_count[name]
    return dict(out)
