"""Op-level trace of one UNet evaluation: where does the time go, and in
which module?

Counterpart of the JAX package's ``ops/trace_unet.py``: one CFG-doubled
evaluation of the video UNet (512 px, 16 frames, bf16, the IP-Adapter
branch; the serving default's int8 convs unless ``--exact``) with seeded
random weights, under ``torch.profiler`` after a warm-up evaluation.  It
reports the device time per kernel and per category (the categoriser of
``tools/profile_step.py``, as the JAX tool categorises XLA ops), and, new
for the port, per module: forward hooks push a ``record_function`` range
named with each module's path, and every kernel is charged to the
innermost module whose range was open on the thread when the kernel was
launched (its CUDA runtime launch, joined to the kernel by the trace's
correlation id).  Kernels launched outside every module go to one bucket,
``OUTSIDE``, so the per-module sums add up to the total.  The JAX tool's
``--pipeline`` mode (a whole-clip dispatch) is not ported:
``tools/profile_step.py`` profiles a request's prep, step and decode.

    python -m i2v_adapter_tpu_torch.ops.trace_unet [--evals N] [--exact] [--top 30] [--device cpu]

prints JSON records (``summary``: totals, categories and the counted
kernels' launches per evaluation -- ``group_norm_fused`` there is how many
GroupNorm sites took the kernel; ``by_module_kind``:
device ms per module class, split by category; ``top_modules``: the
innermost modules with the most device time; ``elementwise``: the
elementwise category's split by module class and its top modules), then
the card's name and power limit.  ``--device cpu`` runs the same hooks and
attribution on the CPU, where the work items are the leaf CPU operators
and their host ms stand in for kernels (``unit: "host_ms"``); nothing
there is a device time.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from i2v_adapter_tpu_torch.device import resolve_device
from i2v_adapter_tpu_torch.ops import launches
from i2v_adapter_tpu_torch.ops.profiling import card_line, emit
from i2v_adapter_tpu_torch.tools.profile_step import category, device_kernels

PREFIX = "module:"  # the range names the hooks push
OUTSIDE = "(outside any module)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def module_ranges(model: torch.nn.Module, root: str = "unet"):
    """While open, every forward of a module under ``model`` runs inside a
    ``record_function`` range named ``PREFIX + its path`` (the root as
    ``root``).  Yields the path -> class name map."""
    kinds, handles, stack = {}, [], []
    for name, module in model.named_modules():
        path = name or root
        kinds[path] = type(module).__name__

        def pre(mod, args, path=path):
            rf = torch.profiler.record_function(PREFIX + path)
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    try:
        yield kinds
    finally:
        for handle in handles:
            handle.remove()


def _events(trace) -> List[dict]:
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def work_items(trace, on_card: bool) -> List[Tuple[str, float, Optional[tuple]]]:
    """``(name, ms, (thread, launch time) or None)`` per unit of work of a
    chrome trace: on the card every kernel, copy and memset, located at its
    CUDA runtime launch (same correlation id); on the CPU every leaf CPU
    operator (one with no operator inside it), at its start."""
    events = [e for e in _events(trace) if e.get("ph") == "X"]
    if on_card:
        launched = {e["args"]["correlation"]: (e.get("tid"), e["ts"]) for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        return [(e["name"], e["dur"] / 1e3, launched.get(e.get("args", {}).get("correlation")))
                for e in events if e.get("cat") in DEVICE_CATS]
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"), key=lambda e: (str(e.get("tid")), e["ts"]))
    items = []
    for i, e in enumerate(ops):
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        inner = nxt is not None and nxt.get("tid") == e.get("tid") and nxt["ts"] < e["ts"] + e["dur"]
        if not inner:
            items.append((e["name"], e["dur"] / 1e3, (e.get("tid"), e["ts"])))
    return items


def attribute(trace, on_card: bool) -> List[Tuple[str, float, str]]:
    """``(name, ms, module path)`` per work item: the innermost module range
    open on the launching thread at its launch, else ``OUTSIDE``.  Ranges
    of one thread nest (the hooks open and close them in call order), so a
    sweep with a stack finds the innermost one.  Where the trace names the
    launching thread otherwise than the ranges' thread and only one thread
    holds ranges, the launches are matched against that thread's ranges
    (the timestamps share one clock)."""
    ranges: Dict[object, List[Tuple[float, float, str]]] = collections.defaultdict(list)
    for e in _events(trace):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX):
            ranges[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]))
    for spans in ranges.values():
        spans.sort(key=lambda s: (s[0], -s[1]))
    located: Dict[object, List[Tuple[float, int]]] = collections.defaultdict(list)
    items = work_items(trace, on_card)
    out: List[Tuple[str, float, str]] = [(name, ms, OUTSIDE) for name, ms, _ in items]
    for i, (_, _, where) in enumerate(items):
        if where is not None:
            located[where[0]].append((where[1], i))
    only = next(iter(ranges.values())) if len(ranges) == 1 else []
    for tid, queries in located.items():
        spans, stack, j = ranges.get(tid, only), [], 0
        for ts, i in sorted(queries):
            while j < len(spans) and spans[j][0] <= ts:
                while stack and stack[-1][1] <= spans[j][0]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][1] <= ts:
                stack.pop()
            if stack:
                out[i] = (out[i][0], out[i][1], stack[-1][2])
    return out


def summarise(attributed, kinds: Dict[str, str], top: int = 30) -> Dict[str, dict]:
    """The per-module tables of ``attributed`` (``attribute``'s result):
    totals by category, by module class (and its categories), the top
    innermost modules, and the elementwise category's split."""
    total = sum(ms for _, ms, _ in attributed)
    by_cat, by_kind, by_path = collections.Counter(), collections.Counter(), collections.Counter()
    kind_cat = collections.defaultdict(collections.Counter)
    elem_kind, elem_path = collections.Counter(), collections.Counter()
    for name, ms, path in attributed:
        cat, kind = category(name), kinds.get(path, OUTSIDE)
        by_cat[cat] += ms
        by_kind[kind] += ms
        by_path[path] += ms
        kind_cat[kind][cat] += ms
        if cat == "elementwise / other":
            elem_kind[kind] += ms
            elem_path[path] += ms
    ordered = lambda c: dict(c.most_common())  # noqa: E731
    return {
        "total_ms": total,
        "module_sum_ms": sum(by_path.values()),
        "outside_ms": by_path.get(OUTSIDE, 0.0),
        "by_category_ms": ordered(by_cat),
        "by_module_kind_ms": ordered(by_kind),
        "by_module_kind_and_category_ms": {k: ordered(kind_cat[k]) for k in by_kind},
        "top_modules_ms": [[p, ms, kinds.get(p, OUTSIDE)] for p, ms in by_path.most_common(top)],
        "elementwise_ms": by_cat.get("elementwise / other", 0.0),
        "elementwise_by_module_kind_ms": ordered(elem_kind),
        "elementwise_top_modules_ms": [[p, ms, kinds.get(p, OUTSIDE)] for p, ms in elem_path.most_common(top)],
    }


def build(model_config, device: torch.device, int8: bool, frames: int, size: int, seed: int = 0):
    """The UNet of ``model_config`` with seeded random weights in bf16 (fp32
    on the CPU) and one CFG-doubled clip's inputs; returns ``(unet,
    evaluate)``."""
    from i2v_adapter_tpu_torch.models import VideoUNet
    from i2v_adapter_tpu_torch.models.layers import prepare_int8
    from i2v_adapter_tpu_torch.utils.random_init import randomize_

    ucfg = model_config.unet.replace(int8_conv=int8)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    unet = randomize_(VideoUNet(ucfg, device=device), seed).to(device, dtype).eval()
    prepare_int8(unet)
    lat = size // model_config.vae.spatial_scale_factor
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn(2, frames, lat, lat, ucfg.in_channels, generator=g, device=device).to(dtype)
    t = torch.full((2,), 501.0, device=device)
    text = torch.randn(2, 77, ucfg.cross_attention_dim, generator=g, device=device).to(dtype)
    img = torch.randn(2, ucfg.image_embed_dim, generator=g, device=device).to(dtype) \
        if ucfg.use_ip_adapter and ucfg.ip_variant == "standard" else None

    def evaluate():
        with torch.inference_mode():
            return unet(x, t, text, img, enable_cross_frame_attn=True)

    return unet, evaluate


def trace(evaluate, unet, device: torch.device, evals: int = 1, top: int = 30) -> Dict[str, dict]:
    """``evals`` evaluations under ``torch.profiler`` with the module
    ranges, after one warm-up; the ``summarise`` tables plus the wall ms,
    the profiler's own kernel total and the kernel count."""
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    evaluate()  # warm-up: kernel builds, cuDNN and cuBLAS plans
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    before = launches.snapshot()
    with module_ranges(unet) as kinds:
        if on_card:
            torch.cuda.synchronize(device)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(evals):
                evaluate()
            if on_card:
                torch.cuda.synchronize(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            chrome = json.load(f)
    attributed = attribute(chrome, on_card)
    tables = summarise(attributed, kinds, top)
    # the profiler's own kernel total, read apart from the trace
    profiler_ms = sum(ms for name, ms in device_kernels(prof)[0].items()
                      if not name.startswith(PREFIX)) if on_card else None
    tables.update(wall_ms=wall_ms, profiler_kernel_ms=profiler_ms, work_items=len(attributed),
                  launches={name: n // evals for name, n in launches.since(before).items()},
                  idle_share=(1.0 - tables["total_ms"] / wall_ms) if on_card else None)
    return tables


def main(argv=None, model_config=None) -> int:
    """The command line; ``model_config`` (default: SD1.5) is for callers
    that trace another architecture from code."""
    from i2v_adapter_tpu_torch.config import I2VModelConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--evals", type=int, default=1, help="evaluations profiled (after one warm-up)")
    ap.add_argument("--exact", action="store_true", help="exact convs (default: the serving default's int8)")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--device", default=None, help="default: the current CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model_config = model_config or I2VModelConfig()
    unet, evaluate = build(model_config, device, not args.exact, args.frames, args.size)
    tables = trace(evaluate, unet, device, args.evals, args.top)
    per = 1.0 / args.evals
    unit = "ms" if device.type == "cuda" else "host_ms"
    scaled = lambda d: {k: v * per for k, v in d.items()}  # noqa: E731
    head = dict(device=str(device), unit=unit, frames=args.frames, size=args.size, int8=not args.exact,
                evals=args.evals, batch=2)
    emit("trace_unet", result="summary", **head, wall_ms=tables["wall_ms"] * per,
         total_ms=tables["total_ms"] * per, module_sum_ms=tables["module_sum_ms"] * per,
         profiler_kernel_ms=None if tables["profiler_kernel_ms"] is None else tables["profiler_kernel_ms"] * per,
         outside_ms=tables["outside_ms"] * per, idle_share=tables["idle_share"],
         work_items=tables["work_items"] // args.evals, launches_per_eval=tables["launches"],
         by_category_ms=scaled(tables["by_category_ms"]))
    emit("trace_unet", result="by_module_kind", **head, ms=scaled(tables["by_module_kind_ms"]),
         by_category_ms={k: scaled(v) for k, v in tables["by_module_kind_and_category_ms"].items()})
    emit("trace_unet", result="top_modules", **head, ms=[[p, ms * per, k] for p, ms, k in tables["top_modules_ms"]])
    emit("trace_unet", result="elementwise", **head, total_ms=tables["elementwise_ms"] * per,
         by_module_kind_ms=scaled(tables["elementwise_by_module_kind_ms"]),
         top_modules_ms=[[p, ms * per, k] for p, ms, k in tables["elementwise_top_modules_ms"]])
    print(card_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
