"""Adapter / motion-module training step on one card.

The counterpart of the JAX package's ``training/train_i2v.py`` (same loss
and conditioning semantics):

* VAE-encode the frames (optionally a few at a time), scale by
  ``scaling_factor``
* CFG condition dropout: text -> the empty-prompt ids; image -> zeroed image
  embeds and a zeroed first-frame latent
* noise with ``noise[:, 0] = 0`` (i2v), offset noise, input perturbation,
  a uniform timestep per clip; ``first_frame_mode='exact'`` restores the
  clean first frame after noising
* epsilon / v-prediction targets; masked MSE without frame 0, the plain
  mean, or the SNR-gamma weighting
* gradients w.r.t. the trainable set only; a non-finite loss or gradient
  norm zeroes the gradients and the updates while the optimizer state
  still advances, as ``tx.update`` on zero gradients does in JAX.

Randomness is explicit: every random number of a step is in ``draws``
(``sample_draws`` makes them from a ``torch.Generator``), so a test can hand
the port the numbers ``jax.random`` drew.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from i2v_adapter_tpu_torch.config import I2VModelConfig, TrainConfig
from i2v_adapter_tpu_torch.device import DTYPES, DeviceLike, resolve_device
from i2v_adapter_tpu_torch.schedulers import add_noise, compute_snr, get_velocity, make_schedule
from i2v_adapter_tpu_torch.training.state import TrainState, ema_update

_COMPUTE_DTYPES = {"none": torch.float32, **DTYPES}


def diffusion_loss(pred, target, timesteps, schedule, snr_gamma: Optional[float],
                   exclude_first_frame: bool) -> torch.Tensor:
    """Loss on (B, F, ...) predictions: masked MSE without frame 0, the
    plain mean, or the SNR-gamma-weighted mean (which, as in the reference,
    does not mask frame 0)."""
    se = (pred - target) ** 2
    if snr_gamma is None:
        if not exclude_first_frame:
            return se.mean()
        mask = torch.ones_like(se)
        mask[:, 0] = 0.0
        return (se * mask).sum() / mask.sum()
    snr = compute_snr(schedule, timesteps).to(se.device)
    if schedule.prediction_type == "v_prediction":
        snr = snr + 1.0
    weights = torch.clamp(snr, max=snr_gamma) / snr
    per_video = se.mean(dim=tuple(range(1, se.ndim)))
    return (per_video * weights).mean()


def sample_draws(model_config: I2VModelConfig, train_config: TrainConfig, pixel_shape,
                 generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every random number of one step for pixels of ``pixel_shape``
    (B, F, H, W, 3): ``posterior_noise`` (B*F, h, w, c), ``timesteps`` (B,),
    ``drop_uniform`` (B,), ``noise`` (B, F, h, w, c), and ``offset``
    (B, F, 1, 1, c) / ``perturbation`` when those options are on."""
    tc = train_config
    b, f, h, w = pixel_shape[:4]
    s, c = model_config.vae.spatial_scale_factor, model_config.vae.latent_channels
    lat = (b, f, h // s, w // s, c)
    randn = lambda *shape: torch.randn(shape, generator=generator, device=device)
    draws = {
        "posterior_noise": randn(b * f, *lat[2:]),
        "timesteps": torch.randint(1 if tc.first_frame_mode == "exact" else 0,
                                   model_config.scheduler.num_train_timesteps, (b,),
                                   generator=generator, device=device),
        "drop_uniform": torch.rand((b,), generator=generator, device=device),
        "noise": randn(*lat),
    }
    if tc.noise_offset > 0:
        draws["offset"] = randn(b, f, 1, 1, c)
    if tc.input_perturbation > 0:
        draws["perturbation"] = randn(*lat)
    return draws


def make_train_step(model_config: I2VModelConfig, train_config: TrainConfig,
                    device: DeviceLike = None):
    """Build ``step_fn(state, batch, generator=None, draws=None) -> (state,
    metrics)``.  ``batch`` holds ``pixel_values`` (B, F, H, W, 3) in [-1, 1]
    (t2i: (B, H, W, 3) allowed), ``text_ids`` / ``uncond_ids`` (B, L) and
    ``clip_image`` (B, S, S, 3), as arrays or tensors.  ``draws`` gives the
    step's random numbers (see ``sample_draws``); without it they come from
    ``generator``, or from a generator seeded with ``seed + step``.  The
    state is updated in place.  Metrics are 0-d tensors on the device:
    ``loss``, ``grad_norm`` and ``skipped_nonfinite``.

    ``step_fn.loss_and_grads(state, batch, draws)`` gives the loss and the
    trainable gradients without updating anything, and
    ``step_fn.draws(state, batch, generator=None)`` the draws a step would
    make."""
    dev = resolve_device(device)
    tc = train_config
    dtype = _COMPUTE_DTYPES[tc.mixed_precision]
    sched_cfg = model_config.scheduler
    if tc.prediction_type is not None:
        sched_cfg = sched_cfg.replace(prediction_type=tc.prediction_type)
    schedule = make_schedule(sched_cfg, device=dev)
    is_t2i = tc.train_mode == "t2i"
    ucfg = model_config.unet

    def as_tensor(x, dtype=None):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x))  # a writable copy (jax arrays are read-only)
        return torch.as_tensor(x, device=dev, dtype=dtype)

    @torch.no_grad()
    def conditioning(state: TrainState, batch, draws):
        pixels = as_tensor(batch["pixel_values"], torch.float32)
        if is_t2i and pixels.ndim == 4:
            pixels = pixels[:, None]
        b, f = pixels.shape[:2]
        flat = pixels.reshape((b * f,) + pixels.shape[2:]).to(dtype)
        latents = state.vae.encode(flat, noise=as_tensor(draws["posterior_noise"], torch.float32),
                                   slice_size=tc.vae_encode_slice)
        latents = (latents * model_config.vae.scaling_factor).float()
        latents = latents.reshape((b, f) + latents.shape[1:])

        u = as_tensor(draws["drop_uniform"])
        drop_text = u < (tc.uncond_prob_t + tc.uncond_prob_ti)
        drop_image = (u >= tc.uncond_prob_t) & (u < tc.uncond_prob_t + tc.uncond_prob_i
                                                + tc.uncond_prob_ti)
        ids = torch.where(drop_text[:, None], as_tensor(batch["uncond_ids"]),
                          as_tensor(batch["text_ids"]))
        text_states = state.text_encoder(ids, dtype=dtype)
        image_embeds = None
        if ucfg.use_ip_adapter:
            image_embeds = state.image_encoder(as_tensor(batch["clip_image"]), dtype=dtype)
            image_embeds = torch.where(drop_image[:, None], torch.zeros_like(image_embeds),
                                       image_embeds)
        if not is_t2i:
            latents[:, 0] *= (~drop_image).to(latents.dtype)[:, None, None, None]

        noise = as_tensor(draws["noise"], torch.float32).clone()
        if not is_t2i:
            noise[:, 0] = 0.0
        if tc.noise_offset > 0:
            noise = noise + tc.noise_offset * as_tensor(draws["offset"], torch.float32)
        timesteps = as_tensor(draws["timesteps"], torch.long)
        if tc.input_perturbation > 0:
            perturbed = noise + tc.input_perturbation * as_tensor(draws["perturbation"], torch.float32)
            noisy = add_noise(schedule, latents, perturbed, timesteps)
        else:
            noisy = add_noise(schedule, latents, noise, timesteps)
        if tc.first_frame_mode == "exact" and not is_t2i:
            noisy[:, 0] = latents[:, 0]
        if schedule.prediction_type == "epsilon":
            target = noise
        elif schedule.prediction_type == "v_prediction":
            target = get_velocity(schedule, latents, noise, timesteps)
        else:
            raise ValueError(schedule.prediction_type)
        return noisy, timesteps, text_states, image_embeds, target

    def loss_and_grads(state: TrainState, batch, draws: Dict):
        """The step's loss and its gradients w.r.t. the trainable set."""
        noisy, timesteps, text_states, image_embeds, target = conditioning(state, batch, draws)
        params = state.trainable_params()
        pred = state.unet(noisy.to(dtype), timesteps, text_states, image_embeds,
                          enable_cross_frame_attn=not is_t2i, dtype=dtype).float()
        loss = diffusion_loss(pred, target, timesteps, schedule, tc.snr_gamma,
                              exclude_first_frame=not is_t2i)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def draws_for(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(tc.seed + state.step)
        shape = tuple(batch["pixel_values"].shape)
        return sample_draws(model_config, tc, shape if len(shape) == 5 else
                            (shape[0], 1) + shape[1:], generator, dev)

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator] = None,
                draws: Optional[Dict] = None):
        if draws is None:
            draws = draws_for(state, batch, generator)
        loss, grads = loss_and_grads(state, batch, draws)
        params = state.trainable_params()

        grad_norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads.values()))
        ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
        grads = {n: torch.where(ok, g, torch.zeros_like(g)) for n, g in grads.items()}
        updates = state.optimizer.update(grads, state.opt_state, params)
        with torch.no_grad():
            for n, p in params.items():
                p.add_(torch.where(ok, updates[n], torch.zeros_like(updates[n])))
        if state.ema is not None:
            ema_update(state.ema, params, tc.ema_decay)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "skipped_nonfinite": (~ok).to(torch.float32)}

    step_fn.loss_and_grads = loss_and_grads
    step_fn.draws = draws_for
    return step_fn
