"""The serving loop: one client in a closed loop on ``I2VAdapterPipeline``.

Set-up makes the weights on the device from the seed, builds the pipeline
at the serving configuration and serves one warm-up request at the cell's
shape, which builds the kernels (on a checkout's first run), plans the
library convolutions and captures the step graphs the window replays.
The window then sends one request after another for ``seconds``; each is a
new condition image, prompt and seed drawn from the run's seed, timed from
its call to the uint8 frames on the host.  With ``--trace 1`` the window's
requests run untraced as well, and one more request runs under the
profiler once the window has closed.

After the window one request drawn from the seed is run again by the plain
reference (``reference/serve.py``) on the same inputs and weights, once
the program is freed, and the two clips are compared frame by frame.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import inputs, trace, weights, work
from portbench.reference import model as ref_model
from portbench.reference import serve as ref_serve

# request keys of the run's generator: the window's i-th request, the
# warm-up request, the draw of the request that is checked
WINDOW, WARMUP, CHECK = 0, 1, 2


def make_request(env, key) -> dict:
    """The inputs of one request, from the run's seed and ``key``."""
    tr, mc = env.traffic, env.config["model"]
    g = inputs.rng(env.seed, *key)
    img = inputs.image(g, tr["height"], tr["width"])
    vocab = mc["text_encoder"]["vocab_size"]
    prompt = inputs.prompt(g, tr["prompt_words"], vocab)
    return {"prompt": prompt, "negative": tr["negative_prompt"], "image": img,
            "ip_image": inputs.resample(img, mc["image_encoder"]["image_size"]),
            "seed": int(g.integers(0, 2 ** 63 - 1)),
            "text_ids": env.tokenizer([tr["negative_prompt"], prompt]),
            "frames": tr["frames"], "height": tr["height"], "width": tr["width"], "steps": tr["steps"],
            "strength": tr["strength"], "guidance": tr["guidance"], "int8": env.config["pipeline"]["int8_conv"]}


def build_pipeline(env, w: Dict[str, torch.Tensor]):
    from i2v_adapter_tpu_torch.config import I2VModelConfig, PipelineConfig
    from i2v_adapter_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, CLIPVisionEncoder, VideoUNet
    from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline

    mc = I2VModelConfig.from_dict(env.config["model"])
    pc = PipelineConfig.from_dict(env.config["pipeline"])
    modules = {"unet": VideoUNet(mc.unet, device="meta"), "vae": AutoencoderKL(mc.vae, device="meta"),
               "text_encoder": CLIPTextEncoder(mc.text_encoder, device="meta"),
               "image_encoder": CLIPVisionEncoder(mc.image_encoder, device="meta")}
    weights.load(modules, w)
    return I2VAdapterPipeline(mc, modules, env.tokenizer, pc, device=env.device)


def call(pipe, req: dict) -> np.ndarray:
    return pipe(req["prompt"], condition_image=req["image"], ip_adapter_image=req["ip_image"],
                negative_prompt=req["negative"], num_frames=req["frames"], height=req["height"],
                width=req["width"], num_inference_steps=req["steps"], guidance_scale=req["guidance"],
                frame_similarity_sample_ratio=req["strength"], seed=req["seed"], output_type="np")


def run(env) -> dict:
    mc = env.config["model"]
    env.tokenizer = inputs.WordTokenizer(mc["text_encoder"]["vocab_size"],
                                         mc["text_encoder"]["max_position_embeddings"])
    dtype = getattr(torch, env.config["pipeline"]["dtype"])
    spec = weights.spec_of(ref_model.build(mc), lambda name: dtype)
    w = weights.make(spec, env.seed, env.device)
    pipe = build_pipeline(env, w)
    call(pipe, make_request(env, (WARMUP,)))
    env.sync()
    setup_s = time.perf_counter() - env.t0

    done: List[dict] = []
    failed = 0

    def serve(i: int, traced: bool = False):
        """Send the window's ``i``-th request; returns its trace, if traced."""
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
    # one more request under the profiler once the window has closed: the
    # window's requests stay untraced
    traced = serve(i, traced=True) if env.trace else None
    attempted = i + (1 if env.trace else 0)
    peak = env.peak_bytes()

    del pipe
    gc.collect()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(env, done, w) if done else [("requests_finished", 0.0, 1.0)]
    env.log(f"set-up {setup_s:.1f} s, {len(done)} requests, the window {window_s:.1f} s, "
            f"reference {time.perf_counter() - t_ref:.1f} s; latencies "
            f"{[round(r['latency_s'], 3) for r in done]}, prep ms {[round(r['timings']['prep_ms'], 1) for r in done]}")
    timed = [r for r in done if not r.get("traced")]
    steps = len(ref_serve.ddim_timesteps(mc["scheduler"], env.traffic["steps"], env.traffic["strength"])[0])
    parts = work.serve_request_sites(mc, make_request(env, (WARMUP,)))
    return {
        "attempted": attempted, "failed": failed, "checks": checks, "peak_bytes": peak, "trace": traced,
        "e2e": {"clip_latency_s": float(np.mean([r["latency_s"] for r in timed])) if timed else None,
                "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
        # the work of one request: each part's products and how often it runs
        "ctx": {"requests": timed, "steps": steps, "traced_units": 1,
                "unit_s": float(np.mean([r["latency_s"] for r in timed])) if timed else None,
                "work": [(parts["prep"], 1), (parts["step"], steps), (parts["decode"], 1)]},
    }


def frame_rms(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each frame's RMS gap in uint8 levels, ``(clips * frames,)``."""
    d = got.astype(np.float64) - want.astype(np.float64)
    return np.sqrt((d ** 2).reshape(d.shape[0] * d.shape[1], -1).mean(axis=1))


def compare(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """The number compared: the worst RMS gap, in uint8 levels, of the
    frames after the first.  The first frame is the decode of the
    condition's clamped latents, which at seeded weights are far smaller
    than the denoised frames' that set the decoder's shared int8 activation
    scale (35 times at the rehearsal's sizes); sound runs read 42-56 levels
    there even against a reference with the same int8 rounding, too near
    the control for any limit, so it is not compared.  The clamp and the decode
    still reach the later frames: through the cross-frame attention to
    frame 0 in every step, and through the same decoder calls
    (``PERF.md``)."""
    return {"later_frames_rms_max": float(frame_rms(got[:, 1:], want[:, 1:]).max())}


def check(env, done: List[dict], w) -> list:
    """Run the reference on one finished request drawn from the seed and
    compare; ``[(name, value, limit)]``."""
    req = done[int(inputs.rng(env.seed, CHECK).integers(len(done)))]
    if env.device.type == "cuda":
        ref_serve.exact_fp32()
    models = ref_serve.reference_models(env.config["model"], env.config["pipeline"], w, env.device)
    want = ref_serve.clip(models, env.config["model"], env.config["pipeline"], req, env.device)
    got = req["out"]
    if got.shape != want.shape:
        return [("clip_shape_equal", 1.0, 0.0)]
    env.log(f"frame RMS gaps {np.round(frame_rms(got, want), 2).tolist()}")
    return [(name, value, env.limits[name]) for name, value in compare(got, want).items()]
