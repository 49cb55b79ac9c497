"""Where the time goes: a torch.profiler breakdown of the serving path.

    python -m i2v_adapter_tpu_torch.tools.profile_step

Builds the full-width (SD1.5) pipeline with seeded random weights on the
GPU, serves one warm-up request, then profiles the three parts of a request
separately (prep, one denoise step, decode).  Prints one JSON line per part:
wall ms (synchronised), summed kernel ms, the device's idle share
(1 - kernel / wall), kernel time by category and the top kernels; then the
nvidia-smi name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

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
    kernels = {}
    for evt in prof.key_averages():
        # device-side events only: operator rows repeat their kernels' time
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        if evt.self_device_time_total > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + evt.self_device_time_total / 1e3
    busy = sum(kernels.values())
    cats = {}
    for name, ms in kernels.items():
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    return {
        "part": label,
        "wall_ms": wall_ms,
        "kernel_ms": busy,
        "idle_share": (1.0 - busy / wall_ms) if busy else None,
        "by_category_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[k[:90], v] for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 2
    from i2v_adapter_tpu_torch.config import I2VModelConfig, PipelineConfig
    from i2v_adapter_tpu_torch.utils import image as image_utils
    from i2v_adapter_tpu_torch.utils.random_init import random_pipeline

    dev = torch.device("cuda", 0)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
