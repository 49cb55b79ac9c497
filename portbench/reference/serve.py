"""The plain reference of one image-to-video request.

From the same token ids, images, request seed and weights as the program:
CLIP text and vision encoders, VAE encode of the condition image, the PIA
similarity prior (Gaussian blur, Bernoulli mask, noise to the first kept
timestep), then per DDIM step the first frame clamped to the condition
latents, the CFG-doubled UNet (uncond: empty prompt, zero image embedding)
and the guided DDIM update (eta 0), then the final clamp and the VAE decode
of every frame in one call to uint8 frames.  Everything runs in float32
with TF32 off; the sites that the configuration runs in int8 take their
int8 operands, worked out again as the configuration states
(``lower.Int8Sites``): one activation scale a call, so the UNet's over both
CFG halves and every frame, the decoder's over every frame.  The random
numbers are drawn again from a device generator seeded with the request's
seed, in the program's order: the posterior noise, the blur sigma, the
mask's uniforms, the prior's noise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from typing import Optional

from portbench.reference.lower import Int8Sites
from portbench.reference.model import EXACT, Precision, build

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def alphas_cumprod(sched: dict) -> torch.Tensor:
    n = sched["num_train_timesteps"]
    if sched["beta_schedule"] == "scaled_linear":
        betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n, dtype=np.float64) ** 2
    else:
        betas = np.linspace(sched["beta_start"], sched["beta_end"], n, dtype=np.float64)
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))


def ddim_timesteps(sched: dict, steps: int, strength: float):
    """Descending linspace timesteps with the leading (1 - strength) cut,
    and their predecessors ``t - T // steps``."""
    n = sched["num_train_timesteps"]
    ts = np.linspace(0, n - 1, steps).round()[::-1].astype(np.int64)
    ts = ts[max(steps - min(int(steps * strength), steps), 0):]
    return ts, ts - n // steps


def blur(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of ``(N, H, W, C)``, reflect padding."""
    half = (size - 1) / 2
    k = torch.exp(-0.5 * (torch.linspace(-half, half, size, device=x.device) / sigma) ** 2)
    k = k / k.sum()
    c = x.shape[-1]
    y = F.pad(x.permute(0, 3, 1, 2), (size // 2,) * 4, mode="reflect")
    y = F.conv2d(y, k.view(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    y = F.conv2d(y, k.view(1, 1, 1, size).expand(c, 1, 1, size), groups=c)
    return y.permute(0, 2, 3, 1)


def reference_models(model_cfg: dict, pipe_cfg: dict, weights: dict, device, prec: Optional[Precision] = None):
    """The four models in float32 on ``device``, the int8 sites of the
    serving configuration marked for ``prec`` (by default the
    configuration's own: int8 where it runs int8, else exact)."""
    from portbench import weights as W

    if prec is None:
        prec = Int8Sites() if pipe_cfg["int8_conv"] else EXACT
    cfg = dict(model_cfg, unet=dict(model_cfg["unet"], int8_conv=pipe_cfg["int8_conv"]),
               vae=dict(model_cfg["vae"], int8_decode=pipe_cfg["int8_conv"]))
    models = build(cfg, prec)
    W.load(models, {k: v.to(device) for k, v in weights.items()}, dtype=torch.float32)
    return models


@torch.no_grad()
def clip(models: dict, model_cfg: dict, pipe_cfg: dict, req: dict, device) -> np.ndarray:
    """The request's ``(1, F, H, W, 3)`` uint8 frames."""
    unet_cfg, sched = model_cfg["unet"], model_cfg["scheduler"]
    vae, scale = models["vae"], model_cfg["vae"]["scaling_factor"]
    text = models["text_encoder"](torch.as_tensor(req["text_ids"], device=device))
    clip_px = (req["ip_image"].astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    embeds = models["image_encoder"](torch.as_tensor(clip_px[None], device=device))
    embeds = torch.cat([torch.zeros_like(embeds), embeds])
    cond = torch.as_tensor(req["image"].astype(np.float32) / 255.0 * 2.0 - 1.0, device=device)[None]

    sf = 2 ** (len(model_cfg["vae"]["block_out_channels"]) - 1)
    frames, h, w = req["frames"], req["height"] // sf, req["width"] // sf
    gen = torch.Generator(device=device).manual_seed(int(req["seed"]))
    post = torch.randn((1, h, w, unet_cfg["in_channels"]), generator=gen, device=device, dtype=torch.float32)
    cond_lat = vae.encode(cond, post) * scale
    sigma = pipe_cfg["blur_sigma"]
    if sigma is None:
        sigma = float(torch.rand((), generator=gen, device=device)) * 1.9 + 0.1
    blurred = blur(cond_lat, pipe_cfg["blur_kernel_size"], sigma)
    shape = (1, frames, h, w, unet_cfg["in_channels"])
    mask = (torch.rand(shape, generator=gen, device=device) < pipe_cfg["frame_similarity_blurred_strength"]).float()
    prior = mask * blurred[:, None] + (1 - mask) * cond_lat[:, None]
    noise = torch.randn(shape, generator=gen, device=device)

    abar = alphas_cumprod(sched).to(device)
    final = abar[0] if not sched["set_alpha_to_one"] else torch.ones((), device=device)
    ts, prev = ddim_timesteps(sched, req["steps"], req["strength"])
    lat = abar[ts[0]].sqrt() * prior + (1 - abar[ts[0]]).sqrt() * noise
    for t, tp in zip(ts, prev):
        lat[:, 0] = cond_lat
        eps = models["unet"](torch.cat([lat, lat]), torch.full((2,), float(t), device=device), text, embeds)
        uncond, cond_eps = eps.chunk(2)
        eps = uncond + req["guidance"] * (cond_eps - uncond)
        a_t = abar[t]
        a_p = abar[tp] if tp >= 0 else final
        x0 = (lat - (1 - a_t).sqrt() * eps) / a_t.sqrt()
        lat = a_p.sqrt() * x0 + (1 - a_p).sqrt() * eps
    lat[:, 0] = cond_lat
    flat = lat.reshape(frames, h, w, -1) / scale
    video = vae.decode(flat)
    video = video.reshape(1, frames, req["height"], req["width"], 3).cpu().numpy()
    return (np.clip(video / 2.0 + 0.5, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def exact_fp32() -> None:
    """Float32 matmuls and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

