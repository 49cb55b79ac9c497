"""What the port's profilers share (``ops/trace_unet.py``,
``ops/profile_unet.py``, ``ops/profile_motion.py``, ``ops/tune.py``): the
device they run on (the card unless ``--device cpu``), device times from
CUDA events, per-call times of calls replayed from one CUDA graph (the
counterpart of the JAX profilers' in-jit ``lax.scan``: host launch cost
stays out of the number), the records they print and the card's name line.

On the CPU a tool checks its plain math and control flow at a small size
and reports no time: its device-time fields are None ("not measured").
"""

from __future__ import annotations

import json
import subprocess
from typing import Callable, Dict, Optional, Tuple

import torch

from i2v_adapter_tpu_torch.ops import launches


def emit(tool: str, **record) -> dict:
    """Print one result as a JSON line and return it."""
    record = {"tool": tool, **record}
    print(json.dumps(record), flush=True)
    return record


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them, printed after a
    tool's records; on the CPU a line that says no device was timed."""
    if device.type != "cuda":
        return "cpu (plain math, no device times)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else None
    return line or f"{torch.cuda.get_device_name(device)}, power limit unavailable (nvidia-smi)"


def event_ms(fn: Callable[[], object], device: torch.device, iters: int = 3) -> Optional[float]:
    """Mean device ms of ``fn`` over ``iters`` calls after one warm-up,
    between two CUDA events; None on the CPU."""
    fn()
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], device: torch.device, iters: int) -> Tuple[Optional[float], Dict[str, int]]:
    """``fn`` run ``iters`` times inside one CUDA graph, replayed once
    between two CUDA events: ``(ms per call, kernel launches per call)``,
    the launches from the counted wrappers (``ops.launches``).  One eager
    call warms up first (the kernels' builds, cuBLAS and cuDNN plans), on
    the side stream the graph is captured on.  On the CPU ``fn`` runs once
    eagerly: ``(None, its launches)``, all 0 there."""
    before = launches.snapshot()
    if device.type != "cuda":
        fn()
        return None, launches.since(before)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
        torch.cuda.synchronize(device)

        def body():
            for _ in range(iters):
                fn()

        graph, counts = launches.capture(body)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launches.replay(graph, counts)
        end.record()
    end.synchronize()
    torch.cuda.current_stream(device).wait_stream(side)
    del graph
    return start.elapsed_time(end) / iters, {k: v // iters for k, v in counts.items() if k != "collectives"}
