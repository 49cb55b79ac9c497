"""What the per-layer metric readers (``metrics/<name>.py``) share.

A reader is ``read(ctx) -> float | None``: ``ctx`` holds the run's
untimed facts (``requests`` or ``steps``: what the window finished,
untraced; ``unit_s``: the mean wall time of an untraced request or
micro-step; ``trace``: the traced slice, or None; ``work``: the products
of one traced unit with how often each part runs; ``peaks``).  A reader
that finds nothing to read returns None and the metric is left out.
"""

from __future__ import annotations

import importlib
from typing import Callable, Optional

import numpy as np

from portbench import trace as tr


def mean_of(rows, fn: Callable) -> Optional[float]:
    vals = [fn(r) for r in rows]
    vals = [v for v in vals if v is not None]
    return float(np.mean(vals)) if vals else None


def bound_s(ctx, work_fn: Callable, peak_key: str) -> float:
    """The least time the chip could take for the traced unit's sites that
    ``work_fn`` counts: the larger of operations over the peak rate and
    bytes over the memory bandwidth, summed site by site."""
    peaks = ctx["peaks"]
    total = 0.0
    for sites, count in ctx["work"]:
        for site in sites:
            wb = work_fn(site)
            if wb is not None:
                total += count * max(wb[0] / peaks[peak_key], wb[1] / peaks["hbm_bytes_per_s"])
    return total


def roofline(ctx, family: str) -> Optional[float]:
    """A kernel family's share of its roofline in the traced slice, %:
    the bound of the work the model needs over the family's device time."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    fam = importlib.import_module(f"portbench.kernels.{family}")
    measured = trace.family_s(fam.PATTERNS) / ctx["traced_units"]
    bound = bound_s(ctx, fam.work, fam.PEAK)
    if measured <= 0 or bound <= 0:
        return None
    return 100.0 * bound / measured


def idle_pct(ctx) -> Optional[float]:
    """The device's idle share of an untraced unit, %: 1 - the union of the
    traced unit's kernel intervals over the mean wall time of the untraced
    units, so that no cost of the profiler enters the wall."""
    trace, unit_s = ctx.get("trace"), ctx.get("unit_s")
    if trace is None or not unit_s or trace.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / ctx["traced_units"] / unit_s)


def step_stream_category_ms(ctx, categories) -> Optional[float]:
    """Device ms per denoise step in ``categories``: the kernels of the
    stream the denoise steps run on (the one with the most kernel time
    other than the stream of the traced slice's last kernel, the decode's),
    over the steps of the traced requests."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    kernels = trace.in_slices()
    if not kernels:
        return None
    last = max(kernels, key=lambda k: k.start + k.dur).stream
    per_stream = {}
    for k in kernels:
        if k.stream != last:
            per_stream[k.stream] = per_stream.get(k.stream, 0.0) + k.dur
    if not per_stream:
        return None
    step_stream = max(per_stream, key=per_stream.get)
    cats = trace.by_category([k for k in kernels if k.stream == step_stream])
    return 1e3 * sum(cats.get(c, 0.0) for c in categories) / (ctx["steps"] * ctx["traced_units"])


def elementwise(ctx) -> Optional[float]:
    return step_stream_category_ms(ctx, tr.ELEMENTWISE)


def serve_mfu(ctx) -> Optional[float]:
    """Operations one request needs (int8 counted at the bf16 rate) over
    its mean untraced latency, as a share of the bf16 peak, %."""
    unit_s = ctx.get("unit_s")
    if not unit_s:
        return None
    ops = sum(count * sum(s.ops for s in sites) for sites, count in ctx["work"])
    return 100.0 * ops / unit_s / ctx["peaks"]["bf16_flops"]


def category_ms(ctx, categories) -> Optional[float]:
    """Device ms per traced unit in ``categories``, every stream."""
    trace = ctx.get("trace")
    if trace is None or not trace.in_slices():
        return None
    cats = trace.by_category()
    return 1e3 * sum(cats.get(c, 0.0) for c in categories) / ctx["traced_units"]


def train_mfu(ctx) -> Optional[float]:
    """Operations one micro-step needs (forward, the backward without the
    recompute) over its untraced mean time, as a share of the bf16 peak, %."""
    step_s = ctx.get("unit_s")
    if not step_s:
        return None
    ops = sum(count * sum(s.ops for s in sites) for sites, count in ctx["work"])
    return 100.0 * ops / step_s / ctx["peaks"]["bf16_flops"]
