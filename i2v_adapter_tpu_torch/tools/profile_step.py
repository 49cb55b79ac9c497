"""Where the time goes: a torch.profiler breakdown of the serving path or
of one training step.

    python -m i2v_adapter_tpu_torch.tools.profile_step           # serving
    python -m i2v_adapter_tpu_torch.tools.profile_step --train   # training
    python -m i2v_adapter_tpu_torch.tools.profile_step --conv-impl pallas [--train]
    python -m i2v_adapter_tpu_torch.tools.profile_step --int8     # the serving default
    python -m i2v_adapter_tpu_torch.tools.profile_step --int8 --dispatch scan   # a replayed step
    python -m i2v_adapter_tpu_torch.tools.profile_step --latent   # the latent zoo

``--conv-impl`` sets ``VideoUNetConfig.conv_impl`` of the profiled model
(``pallas``: every resnet stage through the fused GroupNorm-apply + SiLU +
3x3 conv kernel K4).  ``--int8`` serves with ``PipelineConfig.int8_conv``
on, the serving default: the UNet's and the VAE decoder's convs in int8
(the int8 3x3 conv kernel, K7 for the stride-2 downsamplers); without it
the convs are exact.  ``--dispatch scan`` profiles a denoise step replayed
from the step graphs the warm-up request (``'auto'`` -> ``'scan'``) left
in the pipeline's graph cache, as a repeated request replays them; the
default profiles the stepwise loop's eager step.

Serving builds the full-width (SD1.5) pipeline with seeded random weights
on the GPU, serves one warm-up request, then profiles the three parts of a
request separately (prep, one denoise step, decode).  ``--train`` builds
the reference training workload (``config.reference_train_config``: 2
clips x 16 frames at 256 px, bf16, activation checkpointing) with seeded random
weights and a synthetic batch, takes one warm-up step and profiles the
next.  ``--latent`` profiles the latent zoo at ``chip_smoke.py``'s latent
shapes (defaults, fp32, a 768-wide context): each sampler with CFG over a
50-timestep schedule (SimpleUNet on (1, 32, 32, 4), SimpleUNet3D on (1,
16, 32, 32, 4); the first step eager, the second captured, every step a
replay of its CUDA graph, as over the 1000 train timesteps), reported per
step, and one train step of each (8 x 64x64 latents; 2 clips x 16 frames
of 32x32), after a warm-up run of each.  Prints one JSON line per part: wall ms (synchronised), summed kernel
ms, the device's busy ms (the union of its kernel and copy intervals) and
idle share (1 - busy / wall), kernel time by category, the top kernels, and
the program's spans (``utils.tracing``; the part is a span, and the
pipeline's or the train step's phases open inside it): each span's host and
device ms and the counters that moved, and the device's idle time under the
innermost span open on the host at the middle of each gap
(``idle_under_ms``); then the nvidia-smi name and power limit.
``--trace_dir`` keeps each part's profiler trace there with the spans merged
in (``tracing.export_chrome``).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from i2v_adapter_tpu_torch.ops.profiling import card_line
from i2v_adapter_tpu_torch.utils import tracing

# the serving path's shape: 512px, 16 frames, CFG 7.5; 5 steps keep the
# warm-up request short (the profiled step does not depend on the count)
SIZE, FRAMES, STEPS = 512, 16, 5


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


def device_kernels(prof):
    """``(device ms by kernel name, kernel count, host self ms by operator)``
    of a finished ``torch.profiler`` run; range annotations (user
    ``record_function`` ranges, on either timeline) are left out."""
    kernels, launches, host = {}, 0, {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue
        if evt.device_type == DeviceType.CPU:
            # host-side operators by their own (self) time
            host[evt.key] = host.get(evt.key, 0.0) + evt.self_cpu_time_total / 1e3
            continue
        # device-side events only: operator rows repeat their kernels' time
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + evt.self_device_time_total / 1e3
            launches += evt.count
    return kernels, launches, host


def union(intervals):
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def device_idle(events, part) -> dict:
    """The device's busy ms inside the span ``part`` (the union of the
    trace's kernel and copy intervals, us on the trace's axis), and its idle
    ms under the innermost of ``part``'s spans that was open on the host at
    the middle of each gap."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "program" and e["args"]["root"] == part.id]
    lo, hi = next((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "program" and e["args"]["id"] == part.id)
    busy = union((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and e["ts"] < hi
                 and e["ts"] + e["dur"] > lo)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    under = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        mid = (a + b) / 2
        name = min((s for s in spans if s[0] <= mid <= s[1]), key=lambda s: s[1] - s[0])[2]
        under[name] = under.get(name, 0.0) + (b - a) / 1e3
    return {"busy_ms": sum(b - a for a, b in busy) / 1e3,
            "idle_under_ms": dict(sorted(under.items(), key=lambda kv: -kv[1]))}


def span_table(part) -> list:
    """``[name, host ms, device ms, counters that moved]`` of ``part``'s
    spans, in the order they closed."""
    return [[s.name, round(s.ms, 3), None if s.device_ms is None else round(s.device_ms, 3),
             {k: v for k, v in s.counters.items() if v}] for s in part.unit + [part]]


def profile(fn, label: str, top: int = 12, trace_dir=None) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.span(label) as part:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches, host = device_kernels(prof)
    with tempfile.TemporaryDirectory() as tmp:
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir or tmp, f"{label}.json")
        prof.export_chrome_trace(path)
        tracing.export_chrome(path, merge=path, spans=part.unit + [part])
        with open(path) as f:
            idle = device_idle(json.load(f)["traceEvents"], part)
    cats = {}
    for name, ms in kernels.items():
        cats[category(name)] = cats.get(category(name), 0.0) + ms
    return {
        "part": label,
        "wall_ms": wall_ms,
        "kernel_ms": sum(kernels.values()),
        "busy_ms": idle["busy_ms"],
        "idle_share": 1.0 - idle["busy_ms"] / wall_ms,
        "device_kernels": launches,
        "by_category_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[k[:90], v] for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]],
        "top_host_ops_self_ms": [[k[:60], v] for k, v in sorted(host.items(), key=lambda kv: -kv[1])[:top]],
        "spans": span_table(part),
        "idle_under_ms": idle["idle_under_ms"],
    }


def _model_config(conv_impl: str):
    from i2v_adapter_tpu_torch.config import I2VModelConfig

    cfg = I2VModelConfig()
    return cfg.replace(unet=cfg.unet.replace(conv_impl=conv_impl))


def profile_train(dev, conv_impl: str, trace_dir=None) -> None:
    from i2v_adapter_tpu_torch.config import reference_train_config
    from i2v_adapter_tpu_torch.training import make_train_step
    from i2v_adapter_tpu_torch.utils.random_init import random_train_batch, random_train_state

    model_cfg, tcfg = _model_config(conv_impl), reference_train_config()
    state = random_train_state(model_cfg, tcfg, dev, seed=1)
    batch = random_train_batch(model_cfg, tcfg, dev, seed=0)
    step_fn = make_train_step(model_cfg, tcfg, device=dev)
    step_fn(state, batch)  # warm-up: cuDNN plans, kernel builds
    line = profile(lambda: step_fn(state, batch), "train_step", trace_dir=trace_dir)
    line.update(frames=tcfg.num_frames, size=tcfg.resolution, batch=tcfg.train_batch_size,
                remat=tcfg.gradient_checkpointing, conv_impl=conv_impl)
    print(json.dumps(line), flush=True)


def profile_latent(dev, trace_dir=None) -> None:
    from i2v_adapter_tpu_torch.models.simple import SimpleUNet, SimpleUNet3D
    from i2v_adapter_tpu_torch.training.train_latent import (
        LATENT_SCHEDULE,
        make_latent_train_step,
        make_video_latent_train_step,
        sample_latents,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the zoo is fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    steps = 50
    schedule = LATENT_SCHEDULE.replace(num_train_timesteps=steps)
    ctx = torch.randn(2, 77, 768, generator=gen, device=dev)
    for name, model, make, sample_shape, batch_shape in (
            ("image", SimpleUNet(context_dim=768, device=dev), make_latent_train_step, (1, 32, 32, 4),
             (8, 64, 64, 4)),
            ("video", SimpleUNet3D(context_dim=768, device=dev), make_video_latent_train_step, (1, 16, 32, 32, 4),
             (2, 16, 32, 32, 4))):
        def sample():
            sample_latents(model, sample_shape, gen, context=ctx[:1], schedule_config=schedule)

        batch = {"latents": torch.rand(batch_shape, generator=gen, device=dev) * 2 - 1,
                 "text_embeds": ctx.repeat(batch_shape[0] // 2, 1, 1)}
        init_fn, step_fn = make(model)
        opt = init_fn()
        for label, fn, per in ((f"{name}_sampler_step", sample, steps),
                               (f"{name}_train_step", lambda: step_fn(opt, batch, gen), 1)):
            fn()  # warm-up: cuDNN plans, kernel builds
            line = profile(fn, label, trace_dir=trace_dir)
            if per > 1:  # the sampler: per step of the run
                line.update(steps=per, wall_ms=line["wall_ms"] / per, kernel_ms=line["kernel_ms"] / per,
                            device_kernels=line["device_kernels"] / per,
                            by_category_ms={k: v / per for k, v in line["by_category_ms"].items()})
            line.update(zoo=name, dtype="float32")
            print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true", help="profile one training step")
    ap.add_argument("--conv-impl", default="auto", choices=["auto", "xla", "pallas"],
                    help="VideoUNetConfig.conv_impl of the profiled model")
    ap.add_argument("--int8", action="store_true",
                    help="serve with int8 convs (PipelineConfig.int8_conv, the serving default)")
    ap.add_argument("--dispatch", default="stepwise", choices=["stepwise", "scan"],
                    help="profile the eager step (stepwise) or a step replayed from its CUDA graph (scan)")
    ap.add_argument("--latent", action="store_true",
                    help="profile the latent zoo's samplers and train steps")
    ap.add_argument("--trace_dir", default=None,
                    help="keep each part's profiler trace here, the program's spans merged in")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.latent:
        profile_latent(dev, args.trace_dir)
    elif args.train:
        profile_train(dev, args.conv_impl, args.trace_dir)
    else:
        profile_serving(dev, args.conv_impl, args.int8, args.dispatch, args.trace_dir)
    print(card_line(dev))
    return 0


def profile_serving(dev, conv_impl: str, int8: bool = False, dispatch: str = "stepwise", trace_dir=None) -> None:
    from i2v_adapter_tpu_torch.config import PipelineConfig
    from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import _scan_stream
    from i2v_adapter_tpu_torch.utils import image as image_utils
    from i2v_adapter_tpu_torch.utils.random_init import random_pipeline

    pcfg = PipelineConfig(num_frames=FRAMES, height=SIZE, width=SIZE,
                          num_inference_steps=STEPS, guidance_scale=7.5, blur_sigma=1.0,
                          dtype="bfloat16", int8_conv=int8)
    model_cfg = _model_config(conv_impl)
    pipe = random_pipeline(model_cfg, pcfg, dev)
    image = np.random.default_rng(6).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    # warm-up: cuDNN plans, kernel builds; 'auto' takes 'scan' and keeps its
    # step graphs in the pipeline's cache
    pipe("a cat", condition_image=image, seed=0)
    if dispatch == "scan" and not pipe.last_dispatch.get("graph_cache", {}).get("kept"):
        raise RuntimeError(f"the warm-up request kept no step graphs: {pipe.last_dispatch}")

    parts = pipe._build_parts(1, FRAMES, SIZE, SIZE, STEPS, pcfg.frame_similarity_sample_ratio, 7.5, True, True)
    prep, step, decode, ts, prev, _ = parts
    text_ids = pipe.tokenizer(["", "a cat"])
    cond = image_utils.preprocess_batch(image, SIZE, SIZE)
    clip = image_utils.clip_preprocess(image, model_cfg.image_encoder.image_size)[None]
    gen = torch.Generator(device=dev).manual_seed(0)
    state = {}
    with torch.inference_mode():
        def run_prep():
            state["latents"], state["consts"] = prep(text_ids, cond, clip, gen)

        loop = side = None
        if dispatch == "scan":  # the kept entry, every kind captured: a step is a replay
            run_prep()
            side = _scan_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            loop = next(iter(pipe._graph_cache().values()))
            if "cfg" not in loop.graphs:
                raise RuntimeError(f"the kept entry has no captured 'cfg' step: {sorted(loop.graphs)}")

        def run_step():
            if loop is None:
                state["latents"] = step(state["consts"], state["latents"], ts[0], prev[0])
                return
            with torch.cuda.stream(side):
                loop.step("cfg", ts[2], prev[2])
            torch.cuda.current_stream(dev).wait_stream(side)

        def run_decode():
            state["video"] = decode(state["consts"], state["latents"])

        for label, fn in (("prep", run_prep), ("denoise_step", run_step), ("decode", run_decode)):
            line = profile(fn, label, trace_dir=trace_dir)
            line.update(frames=FRAMES, size=SIZE, batch=1, cfg=True, conv_impl=conv_impl, int8=int8,
                        dispatch=dispatch)
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
