"""The plain reference of the adapter's training steps.

From the same pixels, token ids, CLIP images, draws and weights as the
program, in float32 with TF32 off: the VAE encode (posterior sample), the
text and image towers, i2v conditioning (frame 0's noise zeroed, no
condition dropped at probability 0), noise to each clip's timestep, the
UNet's epsilon prediction and the MSE over frames 1 to F-1, the
gradients of the trainable set (the I2V-Adapter's ``to_q`` and ``to_out``),
gradient accumulation over ``gradient_accumulation_steps`` micro-steps
as a running mean, the clip by global norm and the first AdamW update.
The batch is taken one clip at a time so that the activations fit; the
loss is the whole batch's.  The draws are made again from a device
generator seeded as the program's, in its order: the posterior noise, the
timesteps, the dropout uniforms, the noise.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference.model import EXACT, Precision, build
from portbench.reference.serve import alphas_cumprod


def trainable(name: str, tc: dict) -> bool:
    """The freeze policy: the adapter's query and output projections, and
    the motion modules when the configuration trains them."""
    if not name.startswith("unet."):
        return False
    if "i2v_adapter" in name and ("to_q" in name or "to_out" in name):
        return True
    return bool(tc["update_motion_modules"] and "motion_modules" in name)


def draws(mc: dict, tc: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    b, f, r = tc["train_batch_size"], tc["num_frames"], tc["resolution"]
    s = 2 ** (len(mc["vae"]["block_out_channels"]) - 1)
    c = mc["vae"]["latent_channels"]
    lat = (b, f, r // s, r // s, c)
    return {"posterior_noise": torch.randn((b * f,) + lat[2:], generator=gen, device=device),
            "timesteps": torch.randint(1 if tc["first_frame_mode"] == "exact" else 0,
                                       mc["scheduler"]["num_train_timesteps"], (b,), generator=gen, device=device),
            "drop_uniform": torch.rand((b,), generator=gen, device=device),
            "noise": torch.randn(lat, generator=gen, device=device)}


def models(mc: dict, tc: dict, weights: dict, device, prec: Precision = EXACT) -> dict:
    from portbench import weights as W

    out = build(mc, prec)
    W.load(out, {k: v.to(device) for k, v in weights.items()}, dtype=torch.float32,
           trainable=lambda name: trainable(name, tc))
    return out


def loss_and_grads(m: dict, mc: dict, tc: dict, batch: dict, d: dict):
    """The micro-step's loss and the trainables' gradients, clip by clip."""
    unknown = [k for k in ("noise_offset", "input_perturbation", "snr_gamma") if tc[k]]
    if unknown or tc["train_mode"] != "i2v" or tc["first_frame_mode"] != "scaled" \
            or (mc["scheduler"]["prediction_type"] != "epsilon" or tc["prediction_type"] not in (None, "epsilon")):
        raise ValueError(f"the reference covers i2v epsilon training without {unknown}")
    b, f = batch["pixel_values"].shape[:2]
    abar = alphas_cumprod(mc["scheduler"]).to(d["noise"].device)
    scale = mc["vae"]["scaling_factor"]
    params = {n: p for n, p in m["unet"].named_parameters() if p.requires_grad}
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    drop_t = d["drop_uniform"] < tc["uncond_prob_t"] + tc["uncond_prob_ti"]
    drop_i = (d["drop_uniform"] >= tc["uncond_prob_t"]) & (
        d["drop_uniform"] < tc["uncond_prob_t"] + tc["uncond_prob_i"] + tc["uncond_prob_ti"])
    lat_shape = d["noise"].shape[2:]
    denom = b * (f - 1) * lat_shape.numel()
    total = 0.0
    for c in range(b):
        with torch.no_grad():
            px = batch["pixel_values"][c].float()
            lat = m["vae"].encode(px, d["posterior_noise"][c * f:(c + 1) * f].float()) * scale
            lat = lat[None]
            ids = batch["uncond_ids"][c:c + 1] if drop_t[c] else batch["text_ids"][c:c + 1]
            text = m["text_encoder"](ids)
            emb = m["image_encoder"](batch["clip_image"][c:c + 1].float())
            if drop_i[c]:
                emb = torch.zeros_like(emb)
                lat[:, 0] = 0.0
            noise = d["noise"][c:c + 1].clone()
            noise[:, 0] = 0.0
            t = d["timesteps"][c:c + 1]
            noisy = abar[t].sqrt() * lat + (1 - abar[t]).sqrt() * noise
        pred = m["unet"](noisy, t.float(), text, emb)
        loss = ((pred[:, 1:] - noise[:, 1:]) ** 2).sum() / denom
        for n, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
            grads[n] += g
        total += float(loss.detach())
    return total, grads


def adamw_first_update(acc: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], tc: dict):
    """The parameters' change of the first optimizer update from the
    accumulated gradient: the clip by global norm, then AdamW at count 1
    (the bias-corrected moments are the gradient and its square)."""
    oc = tc["optimizer"]
    if oc["optimizer"] != "adamw" or oc["lr_scheduler"] != "constant":
        raise ValueError("the reference covers AdamW at a constant learning rate")
    norm = torch.sqrt(sum((g * g).sum() for g in acc.values()))
    clip = torch.where(norm >= oc["max_grad_norm"], oc["max_grad_norm"] / norm, torch.ones_like(norm))
    out = {}
    for n, g in acc.items():
        g = g * clip
        u = g / (torch.sqrt(g * g) + oc["adam_epsilon"]) + oc["adam_weight_decay"] * params[n]
        out[n] = -oc["learning_rate"] * u
    return out


def run(m: dict, mc: dict, tc: dict, batches: List[dict], gen: torch.Generator, device):
    """Losses of the first ``len(batches)`` micro-steps, the first
    micro-step's gradients, the accumulated first update's change."""
    k = tc["gradient_accumulation_steps"]
    if len(batches) != k:
        raise ValueError(f"the reference follows one accumulation cycle of {k} micro-steps")
    losses, acc, first = [], None, None
    for i, batch in enumerate(batches):
        loss, grads = loss_and_grads(m, mc, tc, batch, draws(mc, tc, gen, device))
        losses.append(loss)
        if first is None:
            first = {n: g.clone() for n, g in grads.items()}
            acc = {n: torch.zeros_like(g) for n, g in grads.items()}
        for n, g in grads.items():
            acc[n] += (g - acc[n]) / (i + 1)
    params = {n: p.detach() for n, p in m["unet"].named_parameters() if p.requires_grad}
    return losses, first, adamw_first_update(acc, params, tc)
