"""The training loop: back-to-back micro-steps of ``make_train_step``.

Set-up makes the weights on the device from the seed (frozen weights in
their stored dtype, trainables in float32), builds the train state and the
step, stages the batches on the card (pixels uniform in [-1, 1], prompts,
CLIP images, every row different) and drives the step through one whole
accumulation cycle, which warms up every shape and is the part the
reference follows.  The window then runs whole accumulation cycles of
micro-steps on the same state, synchronised at its two ends.  With ``--trace 1`` one more
micro-step runs under the profiler once the window has closed.

After the window the program is freed and the plain reference
(``reference/train.py``) repeats the first cycle from the same weights,
batches and draws; the losses, the first gradient (read from the
accumulator after one micro-step) and the first update's change are
compared leaf by leaf.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import inputs, trace, weights, work
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

# batches staged on the card; the window cycles over them
STAGED = 8
# generator keys of the run's seed
BATCH, DRAWS = 0, 1
# a leaf whose reference gradient norm is under this share of the median
# leaf's moves by round-off alone under Adam and is left out of the change
TINY_GRAD = 1e-3


def make_batch(env, k: int) -> dict:
    mc, tc = env.config["model"], env.config["train"]
    b, f, r = tc["train_batch_size"], tc["num_frames"], tc["resolution"]
    g = inputs.rng(env.seed, BATCH, k)
    vocab, ctx = mc["text_encoder"]["vocab_size"], mc["text_encoder"]["max_position_embeddings"]
    s = mc["image_encoder"]["image_size"]
    prompts = [inputs.prompt(g, env.traffic["prompt_words"], vocab) for _ in range(b)]
    t = lambda a: torch.as_tensor(a, device=env.device)  # noqa: E731
    return {"pixel_values": t(g.random((b, f, r, r, 3), dtype=np.float32) * 2 - 1),
            "text_ids": t(env.tokenizer(prompts).astype(np.int64)),
            "uncond_ids": t(env.tokenizer([""] * b).astype(np.int64)),
            "clip_image": t(g.standard_normal((b, s, s, 3), dtype=np.float32))}


def draw_generator(env) -> torch.Generator:
    seed = int(inputs.rng(env.seed, DRAWS).integers(0, 2 ** 63 - 1))
    return torch.Generator(device=env.device).manual_seed(seed)


def build_state(env, w: Dict[str, torch.Tensor]):
    from i2v_adapter_tpu_torch.config import I2VModelConfig, TrainConfig
    from i2v_adapter_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, CLIPVisionEncoder, VideoUNet
    from i2v_adapter_tpu_torch.training import create_train_state, make_train_step

    mc = I2VModelConfig.from_dict(env.config["model"])
    tc = TrainConfig.from_dict(env.config["train"])
    modules = {"unet": VideoUNet(mc.unet, device="meta"), "vae": AutoencoderKL(mc.vae, device="meta"),
               "text_encoder": CLIPTextEncoder(mc.text_encoder, device="meta"),
               "image_encoder": CLIPVisionEncoder(mc.image_encoder, device="meta")}
    # the program updates its trainables in place: it gets copies
    tcd = env.config["train"]
    weights.load(modules, {k: v.clone() if ref_train.trainable(k, tcd) else v for k, v in w.items()})
    state = create_train_state(modules["unet"], tc, 10 ** 6, vae=modules["vae"],
                               text_encoder=modules["text_encoder"], image_encoder=modules["image_encoder"])
    return state, make_train_step(mc, tc, device=env.device)


def run(env) -> dict:
    mc, tcd = env.config["model"], env.config["train"]
    env.tokenizer = inputs.WordTokenizer(mc["text_encoder"]["vocab_size"],
                                         mc["text_encoder"]["max_position_embeddings"])
    frozen = getattr(torch, tcd["freeze_dtype"])
    spec = weights.spec_of(ref_model.build(mc),
                           lambda n: torch.float32 if ref_train.trainable(n, tcd) else frozen)
    w = weights.make(spec, env.seed, env.device)
    state, step_fn = build_state(env, w)
    batches = [make_batch(env, k) for k in range(STAGED)]
    k = tcd["gradient_accumulation_steps"]
    if k > STAGED:
        raise ValueError(f"accumulation of {k} needs more than {STAGED} staged batches")
    gen = draw_generator(env)
    losses, first = [], None
    for i in range(k):
        state, metrics = step_fn(state, batches[i], generator=gen)
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = {n: a.detach().clone() for n, a in state.opt_state.acc.items()}
    changed = {n: p.detach().float() - w[f"unet.{n}"].float() for n, p in state.trainable_params().items()}
    env.sync()
    setup_s = time.perf_counter() - env.t0

    clips = tcd["train_batch_size"]
    steps = 0
    start = time.perf_counter()
    marks = [start]
    # whole accumulation cycles: every window holds the same share of updates
    while time.perf_counter() - start < env.seconds or steps % k or not steps:
        step_fn(state, batches[(k + steps) % STAGED], generator=gen)
        steps += 1
        marks.append(time.perf_counter())
    env.sync()
    window_s = time.perf_counter() - start
    traced = None
    if env.trace:
        # one more micro-step, the first of a cycle (no update), under the
        # profiler once the window has closed: the window stays untraced
        batch = batches[(k + steps) % STAGED]
        _, traced = trace.record(lambda: step_fn(state, batch, generator=gen), "micro_step")
    peak = env.peak_bytes()

    del state, step_fn, batches
    gc.collect()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(env, w, losses, first, changed)
    env.log(f"set-up {setup_s:.1f} s, {steps} micro-steps in {window_s:.1f} s, "
            f"reference {time.perf_counter() - t_ref:.1f} s, losses {losses}; host s per call "
            f"{np.round(np.diff(marks), 3).tolist()}")
    return {
        "attempted": steps + (1 if traced is not None else 0), "failed": 0, "checks": checks, "peak_bytes": peak, "trace": traced,
        "e2e": {"train_clips_per_s": steps * clips / window_s, "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
        "ctx": {"unit_s": window_s / steps, "traced_units": 1, "steps": 1,
                "work": [(train_sites(env), 1)]},
    }


def train_sites(env) -> List[work.Site]:
    """The products of one micro-step: the towers and the encode, the UNet
    forward, and its backward (``work.backward``)."""
    mc, tcd = env.config["model"], env.config["train"]
    b, f, r = tcd["train_batch_size"], tcd["num_frames"], tcd["resolution"]
    sf = 2 ** (len(mc["vae"]["block_out_channels"]) - 1)
    icfg, ctx = mc["image_encoder"], mc["text_encoder"]["max_position_embeddings"]
    sites = work.clip_sites(mc["text_encoder"], b, ctx)
    sites += work.clip_sites(icfg, b, (icfg["image_size"] // icfg["patch_size"]) ** 2 + 1,
                             patch=icfg["patch_size"], projection=icfg["projection_dim"])
    sites += work.vae_encoder_sites(mc["vae"], r, b * f)
    fwd = work.unet_sites(mc["unet"], r // sf, f, b, ctx, True, False)
    return sites + fwd + work.backward(fwd, trainable=("i2v_adapter_q", "i2v_adapter_out"))


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keep=None) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger
    of the reference leaf's norm and the median leaf's."""
    names = [n for n in want if keep is None or keep(n)]
    g = {n: float(got[n].float().norm()) for n in names}
    r = {n: float(want[n].float().norm()) for n in names}
    median = float(np.median(list(r.values())))
    return max(abs(g[n] - r[n]) / max(r[n], median) for n in names)


def check(env, w, losses, first, changed) -> list:
    mc, tcd = env.config["model"], env.config["train"]
    if env.device.type == "cuda":
        from portbench.reference.serve import exact_fp32

        exact_fp32()
    k = tcd["gradient_accumulation_steps"]
    env.tokenizer = inputs.WordTokenizer(mc["text_encoder"]["vocab_size"],
                                         mc["text_encoder"]["max_position_embeddings"])
    batches = [make_batch(env, i) for i in range(k)]
    m = ref_train.models(mc, tcd, w, env.device)
    want_losses, want_first, want_change = ref_train.run(m, mc, tcd, batches, draw_generator(env), env.device)
    grad_norms = {n: float(g.norm()) for n, g in want_first.items()}
    median = float(np.median(list(grad_norms.values())))
    moved = lambda n: grad_norms[n] >= TINY_GRAD * median  # noqa: E731
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    return [("loss_rel_gap", loss_gap, env.limits["loss_rel_gap"]),
            ("first_grad_leaf_gap", leaf_gaps(first, want_first), env.limits["first_grad_leaf_gap"]),
            ("update_leaf_gap", leaf_gaps(changed, want_change, moved), env.limits["update_leaf_gap"])]
