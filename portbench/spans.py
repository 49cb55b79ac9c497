"""What the readers of the program's spans share (``metrics/*.py`` over the
span recorder ``i2v_adapter_tpu_torch.utils.tracing``): the units of work
they average over.  A program without the recorder, or a ring that lacks
the units, gives None, and the metric is left out.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


def _roots(name: str) -> list:
    try:
        from i2v_adapter_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return []
    return tracing.roots(name)


def untraced_requests(ctx) -> Optional[List]:
    """The window's ``request`` roots: not the warm-up (the first one), not
    the profiled one (it records detail), not a failed one; None unless
    there is one for each of ``ctx["requests"]``."""
    roots = [r for r in _roots("request")[1:] if not r.detail and r.ok]
    return roots if roots and len(roots) == len(ctx.get("requests", [])) else None


def window_micro_steps() -> Optional[List]:
    """The window's ``micro_step`` roots: the untraced ones after the
    warm-up cycle (which ends at the first micro-step that applies an
    update); None if there are none."""
    roots = [r for r in _roots("micro_step") if not r.detail]
    ends = [i for i, r in enumerate(roots) if r.attrs.get("update")]
    return (roots[ends[0] + 1:] or None) if ends else None


def mean_per_unit(units, name: str, value: Callable) -> Optional[float]:
    """The mean over ``units`` of ``value(span)`` summed over each unit's
    spans named ``name``; None if a unit has no such span or a value is
    None."""
    if not units:
        return None
    totals = []
    for unit in units:
        vals = [value(s) for s in unit.find(name)]
        if not vals or None in vals:
            return None
        totals.append(sum(vals))
    return float(np.mean(totals))


def host_ms(s):
    return s.ms


def device_ms(s):
    return s.device_ms


def device_allocs(s):
    return s.counters.get("num_device_alloc")
