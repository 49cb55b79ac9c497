"""Adapter / motion-module training step, on one card or over a mesh.

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

Over a ``(data, fsdp, tensor, seq)`` mesh (``make_train_step(...,
mesh=...)``, the JAX step's pjit over ``batch_sharding``) each rank is one
process holding its block's clips (``data`` x ``fsdp``) and its ``seq``
index's frames of each (``parallel.mesh.local_batch``), and its ZeRO blocks
of the state (``parallel.zero``).  Every rank draws the global batch's
numbers from the same generator and keeps its slab; frame 0's conditioning
acts on the clip's global frame 0, which only ``seq`` index 0 holds; the
UNet runs under the training ``attention_spmd`` context (the sites'
collectives carry gradients, ``parallel.collectives``); each rank's loss
term is its part of the global loss (normalised by the global count, the
SNR path's per-clip means split over ``seq`` as sums), so the trainables'
gradients are the sum over ``data`` x ``fsdp`` x ``seq`` of the ranks'
(``Zero.sum_gradients``); the loss and the gradient norm are the global
values, so every rank takes the same non-finite branch.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

from i2v_adapter_tpu_torch.config import I2VModelConfig, TrainConfig
from i2v_adapter_tpu_torch.device import DTYPES, DeviceLike, resolve_device
from i2v_adapter_tpu_torch.parallel import collectives
from i2v_adapter_tpu_torch.parallel.mesh import CLIP_AXES, GRAD_AXES, SEQ_AXIS, batch_rows, frame_range
from i2v_adapter_tpu_torch.parallel.spmd import attention_spmd
from i2v_adapter_tpu_torch.schedulers import add_noise, compute_snr, get_velocity, make_schedule
from i2v_adapter_tpu_torch.training.state import TrainState, ema_update
from i2v_adapter_tpu_torch.utils import tracing

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


def sharded_diffusion_loss(pred, target, timesteps, schedule, snr_gamma: Optional[float],
                           exclude_first_frame: bool, holds_first_frame: bool, clips: int, frames: int,
                           replicas: int = 1) -> torch.Tensor:
    """This rank's term of ``diffusion_loss`` over a batch of ``clips`` x
    ``frames`` split over the ranks: the terms of all ranks sum to the
    global loss.  ``pred`` / ``target`` hold this rank's clips and frames
    (frame 0 of the clip among them when ``holds_first_frame``);
    ``replicas`` ranks compute the same slab (t2i's pixels are not split
    over ``seq``), each taking its share.  Each branch is a sum over the
    slab divided by the global count: the masked or plain mean, and the SNR
    weighting's per-clip mean (a sum over the clip's frames, split)."""
    se = (pred - target) ** 2
    per_frame = se[0, 0].numel()
    if snr_gamma is None:
        if not exclude_first_frame:
            return se.sum() / (clips * frames * per_frame * replicas)
        if holds_first_frame:
            se = se[:, 1:]
        return se.sum() / (clips * (frames - 1) * per_frame * replicas)
    snr = compute_snr(schedule, timesteps).to(se.device)
    if schedule.prediction_type == "v_prediction":
        snr = snr + 1.0
    weights = torch.clamp(snr, max=snr_gamma) / snr
    per_video = se.sum(dim=tuple(range(1, se.ndim))) / (frames * per_frame)
    return (per_video * weights).sum() / (clips * replicas)


def local_draws(draws: Dict, rows, frame_slice) -> Dict:
    """The slab of a global batch's ``draws`` (``sample_draws``'s) that one
    rank uses: its rows, and of the per-frame draws its frames."""
    r0, r1 = rows
    f0, f1 = frame_slice
    out = {}
    for k, v in draws.items():
        if k in ("timesteps", "drop_uniform"):
            out[k] = v[r0:r1]
        elif k == "posterior_noise":
            b = len(draws["timesteps"])
            v = v.reshape((b, -1) + tuple(v.shape[1:]))[r0:r1, f0:f1]
            out[k] = v.reshape((-1,) + tuple(v.shape[2:]))
        else:
            out[k] = v[r0:r1, f0:f1]
    return out


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
                    device: DeviceLike = None, mesh=None, state_shardings=None):
    """Build ``step_fn(state, batch, generator=None, draws=None) -> (state,
    metrics)``.  ``batch`` holds ``pixel_values`` (B, F, H, W, 3) in [-1, 1]
    (t2i: (B, H, W, 3) allowed), ``text_ids`` / ``uncond_ids`` (B, L) and
    ``clip_image`` (B, S, S, 3), as arrays or tensors.  ``draws`` gives the
    step's random numbers (see ``sample_draws``); without it they come from
    ``generator``, or from a generator seeded with ``seed + step``.  The
    state is updated in place.  Metrics are 0-d tensors on the device:
    ``loss``, ``grad_norm`` and ``skipped_nonfinite``.

    With ``mesh`` (this rank's ``parallel.mesh.Mesh``) the step runs over
    it: ``batch`` is this rank's part of the global batch
    (``parallel.mesh.local_batch``), ``draws`` the global batch's (every
    rank passes the same), the state placed over the mesh (by
    ``state_shardings`` on the first call when ``create_train_state`` did
    not place it), and the metrics are the global step's on every rank.

    ``step_fn.loss_and_grads(state, batch, draws)`` gives the loss and the
    trainable gradients without updating anything (over a mesh the global
    loss and the summed gradients, blocks where the state is sharded), and
    ``step_fn.draws(state, batch, generator=None)`` the draws a step would
    make (the global batch's).

    A call is a ``micro_step`` span (``utils.tracing``) with the children
    ``draws``, ``conditioning`` (the VAE encode, the towers, the noise),
    ``forward`` (the UNet and the loss), ``backward`` (the gradients, the
    checkpointed blocks' recompute included), over a mesh ``grad_sync``
    (the gradients summed and the loss all-reduced over the ranks) and
    ``optimizer`` (the global
    norm, the non-finite guard, the accumulation or the update, EMA), each
    timed on the card by a CUDA event pair on the step's stream in every
    call (read lazily: ``Span.device_ms``, None until the end event has
    run); ``micro_step``'s ``update`` says whether the call applies an
    update."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    tc = train_config
    dtype = _COMPUTE_DTYPES[tc.mixed_precision]
    sched_cfg = model_config.scheduler
    if tc.prediction_type is not None:
        sched_cfg = sched_cfg.replace(prediction_type=tc.prediction_type)
    schedule = make_schedule(sched_cfg, device=dev)
    is_t2i = tc.train_mode == "t2i"
    ucfg = model_config.unet
    clip_ways = 1 if mesh is None else mesh.size(CLIP_AXES)
    seq_ways = 1 if mesh is None else mesh.size(SEQ_AXIS)
    frame_split = not is_t2i and seq_ways > 1
    # ranks that compute the same slab (t2i pixels have no frames to split)
    replicas = seq_ways if is_t2i else 1
    holds_first_frame = mesh is None or mesh.index(SEQ_AXIS) == 0 or not frame_split

    def as_tensor(x, dtype=None):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x))  # a writable copy (jax arrays are read-only)
        return torch.as_tensor(x, device=dev, dtype=dtype)

    def unsharded(state, module):
        return contextlib.nullcontext() if state.zero is None else state.zero.unsharded(module)

    def global_shape(batch):
        """(B, F) of the global batch whose slab this rank holds."""
        shape = tuple(batch["pixel_values"].shape)
        f = shape[1] if len(shape) == 5 else 1
        return shape[0] * clip_ways, f * (seq_ways if frame_split else 1)

    @torch.no_grad()
    def conditioning(state: TrainState, batch, draws):
        pixels = as_tensor(batch["pixel_values"], torch.float32)
        if is_t2i and pixels.ndim == 4:
            pixels = pixels[:, None]
        b, f = pixels.shape[:2]
        if mesh is not None:
            gb, gf = global_shape(batch)
            draws = local_draws(draws, batch_rows(mesh, gb), frame_range(mesh, gf) if frame_split else (0, gf))
        flat = pixels.reshape((b * f,) + pixels.shape[2:]).to(dtype)
        with unsharded(state, state.vae):
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
        with unsharded(state, state.text_encoder):
            text_states = state.text_encoder(ids, dtype=dtype)
        image_embeds = None
        if ucfg.use_ip_adapter:
            with unsharded(state, state.image_encoder):
                image_embeds = state.image_encoder(as_tensor(batch["clip_image"]), dtype=dtype)
            image_embeds = torch.where(drop_image[:, None], torch.zeros_like(image_embeds),
                                       image_embeds)
        first = not is_t2i and holds_first_frame  # this slab holds the clip's frame 0
        if first:
            latents[:, 0] *= (~drop_image).to(latents.dtype)[:, None, None, None]

        noise = as_tensor(draws["noise"], torch.float32).clone()
        if first:
            noise[:, 0] = 0.0
        if tc.noise_offset > 0:
            noise = noise + tc.noise_offset * as_tensor(draws["offset"], torch.float32)
        timesteps = as_tensor(draws["timesteps"], torch.long)
        if tc.input_perturbation > 0:
            perturbed = noise + tc.input_perturbation * as_tensor(draws["perturbation"], torch.float32)
            noisy = add_noise(schedule, latents, perturbed, timesteps)
        else:
            noisy = add_noise(schedule, latents, noise, timesteps)
        if tc.first_frame_mode == "exact" and first:
            noisy[:, 0] = latents[:, 0]
        if schedule.prediction_type == "epsilon":
            target = noise
        elif schedule.prediction_type == "v_prediction":
            target = get_velocity(schedule, latents, noise, timesteps)
        else:
            raise ValueError(schedule.prediction_type)
        return noisy, timesteps, text_states, image_embeds, target

    def local_loss_and_grads(state: TrainState, batch, draws: Dict):
        """This rank's loss term and its gradients w.r.t. the trainable set
        (blocks reduce-scattered over ``fsdp``, not yet summed over the
        other axes)."""
        with tracing.span("conditioning", device_ms=True):
            noisy, timesteps, text_states, image_embeds, target = conditioning(state, batch, draws)
        params = state.trainable_params()
        if mesh is None:
            forward = contextlib.nullcontext()
        else:
            forward = attention_spmd(mesh, clip_axes=CLIP_AXES, frame_split=frame_split,
                                     frames=global_shape(batch)[1])
        # the backward inside the context too: the blocks' activation
        # checkpointing recomputes their forward (and its collectives) there
        with forward:
            with tracing.span("forward", device_ms=True):
                pred = state.unet(noisy.to(dtype), timesteps, text_states, image_embeds,
                                  enable_cross_frame_attn=not is_t2i, dtype=dtype).float()
                if clip_ways * seq_ways == 1:
                    loss = diffusion_loss(pred, target, timesteps, schedule, tc.snr_gamma,
                                          exclude_first_frame=not is_t2i)
                else:
                    gb, gf = global_shape(batch)
                    loss = sharded_diffusion_loss(pred, target, timesteps, schedule, tc.snr_gamma,
                                                  exclude_first_frame=not is_t2i,
                                                  holds_first_frame=holds_first_frame, clips=gb, frames=gf,
                                                  replicas=replicas)
            with tracing.span("backward", device_ms=True):  # the checkpointed blocks' recompute included
                grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def loss_and_grads(state: TrainState, batch, draws: Dict):
        """The step's loss and its gradients w.r.t. the trainable set (over
        a mesh: the global loss, the gradients summed over the ranks)."""
        if mesh is None:
            return local_loss_and_grads(state, batch, draws)
        if state.zero is None:
            from i2v_adapter_tpu_torch.parallel.zero import place_train_state

            place_train_state(state, mesh, state_shardings, frozen_replicated=tc.fsdp_frozen == "replicate")
        # the whole forward recomputed under activation checkpointing, so
        # every rank reissues each block's collectives in the same order
        with set_checkpoint_early_stop(False):
            loss, grads = local_loss_and_grads(state, batch, draws)
        # the gradients' and the loss's reduction over the ranks, timed on the
        # card (the mesh path only: one card's micro-step has no such span)
        with torch.no_grad(), tracing.span("grad_sync", device_ms=True):
            grads = state.zero.sum_gradients(grads)
            loss = collectives.all_reduce(loss.reshape(1), "sum", mesh.group(GRAD_AXES)).reshape(())
        return loss, grads

    def draws_for(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(tc.seed + state.step)
        shape = tuple(batch["pixel_values"].shape)
        gb, gf = global_shape(batch)
        return sample_draws(model_config, tc, (gb, gf) + shape[-3:], generator, dev)

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator] = None,
                draws: Optional[Dict] = None):
        opt = state.optimizer
        with tracing.span("micro_step", update=opt.every_k <= 1 or state.opt_state.mini_step == opt.every_k - 1):
            with tracing.span("draws", device_ms=True):
                if draws is None:
                    draws = draws_for(state, batch, generator)
            loss, grads = loss_and_grads(state, batch, draws)
            with tracing.span("optimizer", device_ms=True):
                params = state.trainable_params()
                grad_norm = state.optimizer.global_norm(grads)
                ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
                grads = {n: torch.where(ok, g, torch.zeros_like(g)) for n, g in grads.items()}
                # the clip's norm: the metric's, or the zeroed gradient's (0) on a skipped step
                clip_norm = torch.where(ok, grad_norm, torch.zeros_like(grad_norm))
                updates = state.optimizer.update(grads, state.opt_state, params, norm=clip_norm)
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
