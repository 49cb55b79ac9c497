"""The Stable Video Diffusion serving loop: one client in a closed loop on
``StableVideoDiffusionPipeline``.

Set-up makes the weights on the device from the seed, builds the pipeline
at the configuration's settings and serves one warm-up request at the
cell's shape, which builds the kernels (on a checkout's first run) and
captures the step graph the window replays.  The window then sends one
request after another for ``seconds``; each is a new condition image and
seed drawn from the run's seed, timed from its call to the uint8 frames on
the host.  With ``--trace 1`` one more request runs under the profiler once
the window has closed.  Under ``--rehearse`` the model and the request
shape are ``rehearse_svd.json``'s.

After the window one finished request drawn from the seed is run again by
the plain reference (``reference/svd.py``) on the same image, seed and
weights, once the program is freed, and the two clips are compared frame
by frame: ``frames_rms_max``, the worst RMS gap in uint8 levels over every
frame.
"""

from __future__ import annotations

import gc
import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench import inputs, trace, weights, work_svd
from portbench.reference import svd as ref_svd

HERE = Path(__file__).resolve().parent
# request keys of the run's generator, as serve.py's
WINDOW, WARMUP, CHECK = 0, 1, 2


def rehearsal_sizes(env) -> None:
    """The tiny model and request shape of ``rehearse_svd.json``."""
    tiny = json.loads((HERE / "rehearse_svd.json").read_text())
    env.config = dict(env.config, model=tiny["model"])
    env.traffic = dict(env.traffic, **tiny["traffic"])


def make_request(env, key) -> dict:
    tr = env.traffic
    g = inputs.rng(env.seed, *key)
    return {"image": inputs.image(g, tr["height"], tr["width"]), "seed": int(g.integers(0, 2 ** 63 - 1)),
            **{k: tr[k] for k in ("height", "width", "frames", "steps", "min_guidance", "max_guidance", "fps",
                                  "motion_bucket_id", "noise_aug_strength", "decode_chunk")}}


def build_pipeline(env, w: Dict[str, torch.Tensor]):
    from i2v_adapter_tpu_torch.config import SVDModelConfig, SVDPipelineConfig
    from i2v_adapter_tpu_torch.models import AutoencoderKLTemporalDecoder, CLIPVisionEncoder, SpatioTemporalUNet
    from i2v_adapter_tpu_torch.pipelines import StableVideoDiffusionPipeline

    mc = SVDModelConfig.from_dict(env.config["model"])
    pc = SVDPipelineConfig.from_dict(env.config["pipeline"])
    modules = {"unet": SpatioTemporalUNet(mc.unet, device="meta"),
               "vae": AutoencoderKLTemporalDecoder(mc.vae, device="meta"),
               "image_encoder": CLIPVisionEncoder(mc.image_encoder, device="meta")}
    weights.load(modules, w)
    return StableVideoDiffusionPipeline(mc, modules, pc, device=env.device)


def call(pipe, req: dict) -> np.ndarray:
    return pipe(req["image"], num_frames=req["frames"], height=req["height"], width=req["width"],
                num_inference_steps=req["steps"], min_guidance_scale=req["min_guidance"],
                max_guidance_scale=req["max_guidance"], fps=req["fps"], motion_bucket_id=req["motion_bucket_id"],
                noise_aug_strength=req["noise_aug_strength"], decode_chunk_size=req["decode_chunk"],
                seed=req["seed"], output_type="np")


def run(env) -> dict:
    if env.rehearse:
        rehearsal_sizes(env)
    mc = env.config["model"]
    dtype = getattr(torch, env.config["pipeline"]["dtype"])
    w = weights.make(weights.spec_of(ref_svd.build(mc), lambda name: dtype), env.seed, env.device)
    pipe = build_pipeline(env, w)
    call(pipe, make_request(env, (WARMUP,)))
    env.sync()
    setup_s = time.perf_counter() - env.t0

    done: List[dict] = []
    failed = 0

    def serve(i: int, traced: bool = False):
        nonlocal failed
        req = make_request(env, (WINDOW, i))
        t0 = time.perf_counter()
        record = None
        try:
            if traced:
                out, record = trace.record(lambda: call(pipe, req), "request")
            else:
                out = call(pipe, req)
        except (FloatingPointError, RuntimeError, ValueError) as err:
            failed += 1
            env.log(f"request {i} failed: {err!r}")
            return None
        req.update(latency_s=time.perf_counter() - t0, out=out, timings=dict(pipe.last_timings), traced=traced)
        done.append(req)
        return record

    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < env.seconds or not done:
        serve(i)
        i += 1
    window_s = time.perf_counter() - start
    traced = serve(i, traced=True) if env.trace else None
    attempted = i + (1 if env.trace else 0)
    peak = env.peak_bytes()

    del pipe
    gc.collect()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(env, done, w) if done else [("requests_finished", 0.0, 1.0)]
    env.log(f"set-up {setup_s:.1f} s, {len(done)} requests, the window {window_s:.1f} s, reference "
            f"{time.perf_counter() - t_ref:.1f} s; latencies {[round(r['latency_s'], 3) for r in done]}, "
            f"step ms {[round(float(np.mean(r['timings']['step_ms'])), 2) for r in done]}, "
            f"decode ms {[round(r['timings']['decode_ms'], 1) for r in done]}")
    timed = [r for r in done if not r.get("traced")]
    unit_s = float(np.mean([r["latency_s"] for r in timed])) if timed else None
    return {
        "attempted": attempted, "failed": failed, "checks": checks, "peak_bytes": peak, "trace": traced,
        "e2e": {"clip_latency_s": unit_s, "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
        "ctx": {"requests": timed, "steps": env.traffic["steps"], "traced_units": 1, "unit_s": unit_s,
                "work": work_svd.request_work(mc, env.traffic)},
    }


def frame_rms(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each frame's RMS gap in uint8 levels."""
    d = got.astype(np.float64) - want.astype(np.float64)
    return np.sqrt((d ** 2).reshape(d.shape[0] * d.shape[1], -1).mean(axis=1))


def check(env, done: List[dict], w) -> list:
    """Run the reference on one finished request drawn from the seed and
    compare its frames; ``[(name, value, limit)]``."""
    from portbench.reference.serve import exact_fp32

    req = done[int(inputs.rng(env.seed, CHECK).integers(len(done)))]
    if env.device.type == "cuda":
        exact_fp32()
    models = ref_svd.reference_models(env.config["model"], w, env.device)
    want, _ = ref_svd.clip(models, env.config["model"], req, env.device)
    got = req["out"]
    if got.shape != want.shape:
        return [("clip_shape_equal", 1.0, 0.0)]
    gaps = frame_rms(got, want)
    env.log(f"frame RMS gaps {np.round(gaps, 2).tolist()}")
    return [("frames_rms_max", float(gaps.max()), env.limits["frames_rms_max"])]
