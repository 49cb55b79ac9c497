"""Spans and counters of the port's units of work: a serving request, a
training micro-step, a daemon job.

``with span(name):`` opens one phase of the work.  Spans nest through a
per-thread stack: each records its parent's id and its root's (the unit's
first span, opened with no span open on its thread), so a request's or a
micro-step's spans share one root id with no argument passed down.  A span
keeps its start and end on the host clock that ``torch.profiler``'s
exported traces use (``time.time_ns``: an event's ``ts`` x 1000 plus the
trace's ``baseTimeNanoseconds``), so a device gap in a profiler trace lies
under the program span that was open on the host at that moment.

Two levels:

* **phase** (always): a span reads the host clock at its two edges and, at
  the points that ask for them by name (``counters=("alloc",)`` at a
  synchronised edge), those counters; it makes no synchronisation, no CUDA
  event and no device allocation, but for a span opened with
  ``device_ms=True`` (the train step's phases, the scan loop's steps),
  which records a CUDA event pair at its edges.
* **detail** (while a ``torch.profiler`` records, or after ``enable()``):
  every span also reads every counter at its edges and times its device
  work with a CUDA event pair on the current stream, read once the end
  event has completed (``device_ms``), never by a synchronisation of its
  own; on the CPU, where operators run as they are called, the host clock
  stands for the device.

Counters, as deltas over a span: ``launches``, the kernel wrappers'
launches (``ops.launches.snapshot``) and the collectives' calls
(``parallel.collectives.calls``); ``alloc``, the CUDA caching allocator's
``num_device_alloc``, ``num_device_free`` and ``num_alloc_retries``.

Closed spans go to a ring of ``RING_SPANS`` (``roots()`` reads it); a span
also keeps the spans closed under it (``unit``, ``find``).  ``export_chrome``
writes them into a ``torch.profiler`` Chrome trace on its time axis.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

RING_SPANS = 4096
ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")
COUNTER_GROUPS = ("launches", "alloc")

_ring: "collections.deque[Span]" = collections.deque(maxlen=RING_SPANS)
_local = threading.local()
_ids = itertools.count(1)
_forced = False


class Span:
    """One closed (or open) phase; times in ns on the profiler's clock."""

    __slots__ = ("name", "id", "parent", "root", "tid", "detail", "attrs", "start_ns", "end_ns", "ok",
                 "counters", "unit", "_events", "_device_ms")

    def __init__(self, name: str, parent: Optional["Span"], detail: bool, attrs: dict):
        self.name, self.id, self.detail, self.attrs = name, next(_ids), detail, attrs
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.tid = threading.get_native_id()
        self.start_ns = self.end_ns = 0
        self.ok = True
        self.counters: Dict[str, int] = {}
        self.unit: List[Span] = []  # the closed spans under this one, in closing order
        self._events = None
        self._device_ms: Optional[float] = None

    @property
    def ms(self) -> float:
        """Host wall ms."""
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Device ms between the span's edges (detail, or a span timed on
        the device by its caller); None if not timed or not yet finished."""
        if self._events is not None and self._events[1].query():
            self._device_ms = self._events[0].elapsed_time(self._events[1])
            self._events = None
        return self._device_ms

    def find(self, name: str) -> List["Span"]:
        """The spans named ``name`` under this one, in closing order."""
        return [s for s in self.unit if s.name == name]

    def record(self) -> dict:
        """The span as a JSON-able dict (the Chrome event's ``args``)."""
        rec = {"id": self.id, "parent": self.parent, "root": self.root, "ms": self.ms, **self.attrs}
        if self.device_ms is not None:
            rec["device_ms"] = self.device_ms
        if self.counters:
            rec["counters"] = dict(self.counters)
        if not self.ok:
            rec["ok"] = False
        return rec


def enable(on: bool = True) -> None:
    """Record detail without a profiler (or stop)."""
    global _forced
    _forced = on


def detail() -> bool:
    return _forced or torch._C._autograd._profiler_enabled()


def clear() -> None:
    _ring.clear()


def roots(name: str) -> List[Span]:
    """The ring's closed root spans named ``name``, oldest first."""
    return [s for s in _ring if s.parent is None and s.name == name]


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _counters(groups: Sequence[str]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    if "launches" in groups:
        from i2v_adapter_tpu_torch.ops import launches
        from i2v_adapter_tpu_torch.parallel import collectives

        out.update(launches.snapshot(), collectives=collectives.calls)
    if "alloc" in groups and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        out.update((k, stats.get(k, 0)) for k in ALLOC_KEYS)
    return out


def _cuda_event():
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


@contextlib.contextmanager
def span(name: str, *, counters: Sequence[str] = (), device_ms: Optional[bool] = None,
         **attrs) -> Iterator[Span]:
    """Open the span ``name`` on this thread until the block ends.

    ``counters``: groups of ``COUNTER_GROUPS`` read at the edges even at
    the phase level (every group is read at detail).  ``device_ms``: True
    times the device always, False never, None at detail.  ``attrs`` are
    facts of the span (``Span.attrs``)."""
    stack = _stack()
    parent = stack[-1] if stack else None
    on = detail()
    s = Span(name, parent, on, attrs)
    groups = COUNTER_GROUPS if on else counters
    before = _counters(groups) if groups else None
    timed = on if device_ms is None else device_ms
    cuda = timed and torch.cuda.is_initialized()
    events = cuda and not torch.cuda.is_current_stream_capturing()
    start = _cuda_event() if events else None
    stack.append(s)
    s.start_ns = time.time_ns()
    try:
        yield s
    except BaseException:
        s.ok = False
        raise
    finally:
        if events:
            s._events = (start, _cuda_event())
        s.end_ns = time.time_ns()
        stack.pop()
        if timed and not cuda:
            s._device_ms = s.ms
        if before is not None:
            after = _counters(groups)
            s.counters = {k: v - before[k] for k, v in after.items()}
        _ring.append(s)
        for outer in stack:
            outer.unit.append(s)


def export_chrome(path: str, merge: str, spans: Optional[Sequence[Span]] = None) -> str:
    """Write ``spans`` (default: the ring's) that overlap the events of the
    ``torch.profiler`` Chrome trace at ``merge`` (which may be ``path``
    itself) into it as complete events (category ``program``, on their
    threads' rows), on its time axis: ``ts`` in us after its
    ``baseTimeNanoseconds``.  The result goes to ``path``, which is
    returned."""
    spans = list(_ring) if spans is None else list(spans)
    with open(merge) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    timed = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "ts" in e]
    if timed:
        lo = min(float(e["ts"]) for e in timed) * 1e3 + base
        hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in timed) * 1e3 + base
        spans = [s for s in spans if s.end_ns >= lo and s.start_ns <= hi]
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3, "args": s.record()} for s in spans)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path
