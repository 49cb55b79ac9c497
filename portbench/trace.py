"""Device traces: one slice of a run under ``torch.profiler``, read back as
kernel intervals and the host's CUDA calls.

On a card the profiler records the device's activity alone (kernels,
copies and the CUDA runtime calls): recording every host operator as well
slowed a 16 k-launch training micro-step from 1.07 s to 1.44-1.52 s, so
the slice's wall time no longer stood for the untraced run's.  The slice's
wall time is the host clock's, from the call to the synchronised end; the
union of the kernel intervals is the device's busy time (overlapping
streams are counted once).  Idle gaps are named by the host call that
overlaps the gap most (and by the innermost benchmark span where the trace
has spans: the CPU rehearsal records host operators).  Kernel categories
are the benchmark's frozen copy of the program's profiler table
(``tools/profile_step.py::category``).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

SPAN_PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def category(name: str) -> str:
    """A device kernel's category, from its name."""
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention (K1)"
    if "temporal_fwd" in n or "temporal_mma" in n:
        return "temporal_attention_cs (K2)"
    if "bwd_dq" in n or "bwd_dkv" in n or "bwd_prep" in n:
        return "flash_attention_bwd (K3)"
    if "int8_conv3x3" in n:
        return "int8 3x3 conv"
    if "quantize_weights" in n:
        return "int8 weight quantiser"
    if "int8_mm" in n:
        return "int8_matmul (K7)"
    if "conv3x3_wgmma" in n or "conv3x3_f32" in n or "pack_weights" in n:
        return "conv3x3_kernel (K4)"
    if "conv" in n or "implicit" in n or "winograd" in n or "fprop" in n:
        return "convolution"
    if any(key in n for key in ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if "reduce" in n or "norm" in n or "welford" in n or "softmax" in n:
        return "reduction / norm / softmax"
    return "elementwise / other"


ELEMENTWISE = ("elementwise / other", "reduction / norm / softmax")


@dataclass
class Kernel:
    name: str
    start: float  # microseconds
    dur: float
    stream: int


@dataclass
class Trace:
    kernels: List[Kernel]
    spans: List[Tuple[str, float, float]]  # benchmark spans: (name, start, end)
    host_ops: List[Tuple[str, float, float]]  # host operators and CUDA calls
    slices: List[Tuple[float, float]] = field(default_factory=list)  # traced windows
    host_wall_s: Optional[float] = None  # the slices' wall time on the host clock

    def in_slices(self) -> List[Kernel]:
        return [k for k in self.kernels if any(a <= k.start < b for a, b in self.slices)]

    def wall_s(self) -> float:
        if self.host_wall_s is not None:
            return self.host_wall_s
        return sum(b - a for a, b in self.slices) / 1e6

    def busy_s(self) -> float:
        return sum(b - a for a, b in union((k.start, k.start + k.dur) for k in self.in_slices())) / 1e6

    def family_s(self, patterns: Sequence[str]) -> float:
        return sum(k.dur for k in self.in_slices() if any(p in k.name for p in patterns)) / 1e6

    def by_category(self, kernels: Optional[List[Kernel]] = None) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k in self.in_slices() if kernels is None else kernels:
            out[category(k.name)] = out.get(category(k.name), 0.0) + k.dur / 1e6
        return out

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The ``top`` longest stretches of the slices with no device
        operation running, longest first, each named by ``_what``."""
        gaps = []
        for a, b in self.slices:
            busy = union((max(k.start, a), min(k.start + k.dur, b)) for k in self.in_slices()
                         if k.start < b and k.start + k.dur > a)
            edges = [a] + [x for iv in busy for x in iv] + [b]
            gaps += [(lo, hi) for lo, hi in zip(edges[0::2], edges[1::2]) if hi > lo]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return [(self._what(lo, hi), (hi - lo) / 1e6) for lo, hi in gaps]

    def _what(self, lo: float, hi: float) -> str:
        spans = [s for s in self.spans if s[1] <= lo < s[2]]
        overlap = [(min(e, hi) - max(s, lo), n) for n, s, e in self.host_ops if s < hi and e > lo]
        parts = [min(spans, key=lambda s: s[2] - s[1])[0]] if spans else []
        if overlap:
            parts.append(max(overlap)[1])
        elif not spans:
            parts.append("host work between CUDA calls")
        return ": ".join(parts)


def union(intervals) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def record(fn: Callable[[], object], slice_span: str):
    """Run ``fn()`` under the profiler, inside the span ``slice_span``;
    returns ``(fn's result, Trace)``.  On a card the profiler records the
    device alone, on the CPU (a rehearsal) the host operators.  The trace
    file is written to a temporary directory and removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(SPAN_PREFIX + slice_span):
            t0 = time.perf_counter()
            result = fn()
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    return result, parse(events, slice_span, wall)


def parse(events, slice_span: str, host_wall_s: Optional[float] = None) -> Trace:
    """A ``Trace`` from a Chrome trace (a dict with ``traceEvents`` or the
    list itself).  The slices are the spans named ``slice_span``; a trace
    without them (the device alone) is one slice from its first recorded
    event to its last."""
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    kernels, spans, ops = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name, ts, dur = e.get("cat", ""), e.get("name", ""), float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            kernels.append(Kernel(name, ts, dur, int((e.get("args") or {}).get("stream", -1))))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], ts, ts + dur))
        elif cat in HOST_CATS:
            ops.append((name, ts, ts + dur))
    slices = [(s, e) for n, s, e in spans if n == slice_span]
    if not slices and (kernels or ops):
        slices = [(min([k.start for k in kernels] + [s for _, s, _ in ops]),
                   max([k.start + k.dur for k in kernels] + [e for _, _, e in ops]))]
    return Trace(kernels, spans, ops, slices, host_wall_s)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The ``breakdown`` of a result line: device time by category and the
    longest idle gaps, seconds each."""
    cats = sorted(trace.by_category().items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in cats], "idle_gaps": [[k, v] for k, v in trace.idle_gaps(top)]}
