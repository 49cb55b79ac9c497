"""Where the time goes: a torch.profiler breakdown of the serving path or
of one training step.

    python -m i2v_adapter_tpu_torch.tools.profile_step           # serving
    python -m i2v_adapter_tpu_torch.tools.profile_step --train   # training

Serving builds the full-width (SD1.5) pipeline with seeded random weights
on the GPU, serves one warm-up request, then profiles the three parts of a
request separately (prep, one denoise step, decode).  ``--train`` builds
the reference training workload (``config.reference_train_config``: 2
clips x 16 frames at 256 px, bf16, activation checkpointing) with seeded random
weights and a synthetic batch, takes one warm-up step and profiles the
next.  Prints one JSON line per part: wall ms (synchronised), summed kernel
ms, the device's idle share (1 - kernel / wall), kernel time by category
and the top kernels; then the nvidia-smi name and power limit.  Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

# the serving path's shape: 512px, 16 frames, CFG 7.5; 5 steps keep the
# warm-up request short (the profiled step does not depend on the count)
SIZE, FRAMES, STEPS = 512, 16, 5


def _category(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention (K1)"
    if "temporal_fwd" in n:
        return "temporal_attention_cs (K2)"
    if "bwd_dq" in n or "bwd_dkv" in n:
        return "flash_attention_bwd (K3)"
    if "conv" in n or "implicit" in n or "winograd" in n or "fprop" in n:
        return "convolution"
    if any(key in n for key in ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if "reduce" in n or "norm" in n or "welford" in n or "softmax" in n:
        return "reduction / norm / softmax"
    return "elementwise / other"


def profile(fn, label: str, top: int = 12) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    busy = sum(kernels.values())
    cats = {}
    for name, ms in kernels.items():
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    return {
        "part": label,
        "wall_ms": wall_ms,
        "kernel_ms": busy,
        "idle_share": (1.0 - busy / wall_ms) if busy else None,
        "device_kernels": launches,
        "by_category_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[k[:90], v] for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]],
        "top_host_ops_self_ms": [[k[:60], v] for k, v in sorted(host.items(), key=lambda kv: -kv[1])[:top]],
    }


def profile_train(dev) -> None:
    from i2v_adapter_tpu_torch.config import I2VModelConfig, reference_train_config
    from i2v_adapter_tpu_torch.training import make_train_step
    from i2v_adapter_tpu_torch.utils.random_init import random_train_batch, random_train_state

    model_cfg, tcfg = I2VModelConfig(), reference_train_config()
    state = random_train_state(model_cfg, tcfg, dev, seed=1)
    batch = random_train_batch(model_cfg, tcfg, dev, seed=0)
    step_fn = make_train_step(model_cfg, tcfg, device=dev)
    step_fn(state, batch)  # warm-up: cuDNN plans, kernel builds
    line = profile(lambda: step_fn(state, batch), "train_step")
    line.update(frames=tcfg.num_frames, size=tcfg.resolution, batch=tcfg.train_batch_size,
                remat=tcfg.gradient_checkpointing)
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true", help="profile one training step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.train:
        profile_train(dev)
    else:
        profile_serving(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable")
    return 0


def profile_serving(dev) -> None:
    from i2v_adapter_tpu_torch.config import I2VModelConfig, PipelineConfig
    from i2v_adapter_tpu_torch.utils import image as image_utils
    from i2v_adapter_tpu_torch.utils.random_init import random_pipeline

    pcfg = PipelineConfig(num_frames=FRAMES, height=SIZE, width=SIZE,
                          num_inference_steps=STEPS, guidance_scale=7.5, blur_sigma=1.0,
                          dtype="bfloat16", int8_conv=False)
    model_cfg = I2VModelConfig()
    pipe = random_pipeline(model_cfg, pcfg, dev)
    image = np.random.default_rng(6).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    pipe("a cat", condition_image=image, seed=0)  # warm-up: cuDNN plans, kernel builds

    prep, step, decode, ts, prev = pipe._build_parts(
        1, FRAMES, SIZE, SIZE, STEPS, pcfg.frame_similarity_sample_ratio,
        7.5, True, True,
    )
    text_ids = pipe.tokenizer(["", "a cat"])
    cond = image_utils.preprocess_batch(image, SIZE, SIZE)
    clip = image_utils.clip_preprocess(image, model_cfg.image_encoder.image_size)[None]
    gen = torch.Generator(device=dev).manual_seed(0)
    state = {}
    with torch.inference_mode():
        def run_prep():
            state["latents"], state["consts"] = prep(text_ids, cond, clip, gen)

        def run_step():
            state["latents"] = step(state["consts"], state["latents"], ts[0], prev[0])

        def run_decode():
            state["video"] = decode(state["consts"], state["latents"])

        for label, fn in (("prep", run_prep), ("denoise_step", run_step), ("decode", run_decode)):
            line = profile(fn, label)
            line.update(frames=FRAMES, size=SIZE, batch=1, cfg=True)
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
