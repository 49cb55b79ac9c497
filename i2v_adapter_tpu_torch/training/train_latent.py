"""From-scratch latent-diffusion trainers for the simple model zoo (the
JAX package's ``training/train_latent.py``).

A linear-beta DDPM schedule, closed-form q-sample, CFG text dropout, epsilon
MSE, and ``optax.adamw(lr)`` alone (b1 0.9, b2 0.999, eps 1e-8, weight
decay 1e-4 on every parameter, no clipping, no schedule) through the
port's AdamW math (``training.state.adamw_updates``); the full ancestral
sampling loop with CFG, one step replayed from a CUDA graph on the card;
checkpoints of Flax-named tensors that both
packages read.

Randomness is explicit.  A step's timesteps, noise and CFG drop draws come
from a ``torch.Generator`` or are handed in (``draws``), so a test can feed
the numbers ``jax.random`` drew; ``sample_latents`` likewise takes its
starting noise and per-step noise from a generator or from the caller.
The parameters are the model's own and are updated in place.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from i2v_adapter_tpu_torch.config import SchedulerConfig
from i2v_adapter_tpu_torch.models.simple import SimpleUNet, SimpleUNet3D
from i2v_adapter_tpu_torch.ops import launches
from i2v_adapter_tpu_torch.schedulers import add_noise, ddpm_step, make_schedule
from i2v_adapter_tpu_torch.training.state import OptState, adamw_updates
from i2v_adapter_tpu_torch.utils import convert

# the reference's hand-rolled schedule
LATENT_SCHEDULE = SchedulerConfig(
    num_train_timesteps=1000,
    beta_start=1e-4,
    beta_end=0.02,
    beta_schedule="linear",
    clip_sample=False,
)

# optax.adamw's defaults
ADAMW_B1, ADAMW_B2, ADAMW_EPS, ADAMW_WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_latent_train_step(
    model: nn.Module,
    schedule_config: SchedulerConfig = LATENT_SCHEDULE,
    learning_rate: float = 1e-4,
    uncond_prob: float = 0.1,
    is_video: bool = False,
    image_only: bool = False,
):
    """Returns ``(init_fn, step_fn)``.  ``init_fn()`` gives a zero AdamW
    state for every parameter of ``model``; ``step_fn(opt_state, batch,
    generator=None, draws=None) -> (opt_state, loss)`` takes ``batch``
    ``latents`` (B, [T,] H, W, C) in [-1, 1] and optionally ``text_embeds``
    (B, L, D), as arrays or tensors, and updates the parameters in place.

    ``is_video`` targets a SimpleUNet3D; ``image_only`` runs it with the
    temporal branches blended out, and image batches (B, H, W, C) are
    lifted to T = 1 clips.  ``draws`` holds ``timesteps`` (B,), ``noise``
    (the latents' shape) and ``drop_uniform`` (B,); without it they come
    from ``generator``."""
    dev = _device_of(model)
    schedule = make_schedule(schedule_config, device=dev)
    params = dict(model.named_parameters())

    def as_tensor(x, dtype=None):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x))
        return torch.as_tensor(x, device=dev, dtype=dtype)

    def lift(latents):
        return latents[:, None] if is_video and latents.ndim == 4 else latents

    def init_fn() -> OptState:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}  # noqa: E731
        return OptState(mu=zeros(), nu=zeros())

    def draws_for(batch, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        shape = tuple(lift(as_tensor(batch["latents"])).shape)
        b = shape[0]
        return {
            "timesteps": torch.randint(0, schedule.num_train_timesteps, (b,), generator=generator, device=dev),
            "noise": torch.randn(shape, generator=generator, device=dev),
            "drop_uniform": torch.rand((b,), generator=generator, device=dev),
        }

    def loss_and_grads(batch, draws):
        latents = lift(as_tensor(batch["latents"], torch.float32))
        t = as_tensor(draws["timesteps"], torch.long)
        noise = as_tensor(draws["noise"], torch.float32)
        noisy = add_noise(schedule, latents, noise, t)
        context = batch.get("text_embeds")
        if context is not None:
            context = as_tensor(context, torch.float32)
            if uncond_prob > 0:
                drop = as_tensor(draws["drop_uniform"]) < uncond_prob
                context = torch.where(drop[:, None, None], torch.zeros_like(context), context)
        if is_video:
            pred = model(noisy, t, context, image_only=image_only)
        else:
            pred = model(noisy, t, context)
        loss = torch.mean((pred - noise) ** 2)
        # image_only leaves the blenders' mix factors out of the graph, a
        # model given no context its cross-attention: zero gradients, as JAX
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                               for (n, p), g in zip(params.items(), grads)}

    def step_fn(opt_state: OptState, batch, generator: Optional[torch.Generator] = None,
                draws: Optional[Dict] = None):
        if draws is None:
            draws = draws_for(batch, generator)
        loss, grads = loss_and_grads(batch, draws)
        opt_state.count += 1
        updates = adamw_updates(grads, opt_state, params, learning_rate, ADAMW_B1, ADAMW_B2, ADAMW_EPS,
                                ADAMW_WEIGHT_DECAY)
        with torch.no_grad():
            for n, p in params.items():
                p.add_(updates[n].to(p.dtype))
        return opt_state, loss

    return init_fn, step_fn


def make_video_latent_train_step(model: nn.Module, image_only: bool = False, **kwargs):
    """The video-latent trainer on a SimpleUNet3D; ``image_only=True``
    trains the same UNet on single frames with the temporal branches
    blended out (joint image + video training)."""
    return make_latent_train_step(model, is_video=True, image_only=image_only, **kwargs)


def _sampler_setup(model, shape, generator, context, guidance_scale, schedule_config, x0, noises):
    """What both samplers share: the schedule on the model's device, the
    starting noise, the CFG context concatenated once, one step's function
    ``step(x, t, noise)`` (``t`` a 0-d device timestep) and step ``i``'s
    noise, drawn from ``generator`` or taken from ``noises``."""
    dev = _device_of(model)
    schedule = make_schedule(schedule_config, device=dev)
    use_cfg = context is not None and guidance_scale > 1.0
    x = (torch.randn(tuple(shape), generator=generator, device=dev) if x0 is None
         else torch.as_tensor(x0, device=dev, dtype=torch.float32))
    ctx = None
    if context is not None:
        context = torch.as_tensor(context, device=dev, dtype=torch.float32)
        ctx = torch.cat([torch.zeros_like(context), context]) if use_cfg else context

    def step(x, t, noise):
        t = t.expand(x.shape[0])
        if use_cfg:
            eps_u, eps_c = model(torch.cat([x, x]), t.repeat(2), ctx).chunk(2)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
        else:
            eps = model(x, t, ctx)
        return ddpm_step(schedule, eps, t, x, noise)

    def noise_of(i):
        return (torch.randn(x.shape, generator=generator, device=dev) if noises is None
                else torch.as_tensor(noises[i], device=dev, dtype=torch.float32))

    return schedule.num_train_timesteps, x, step, noise_of


@torch.no_grad()
def sample_latents(
    model: nn.Module,
    shape,
    generator: Optional[torch.Generator] = None,
    context: Optional[torch.Tensor] = None,
    guidance_scale: float = 7.5,
    schedule_config: SchedulerConfig = LATENT_SCHEDULE,
    x0: Optional[torch.Tensor] = None,
    noises=None,
) -> torch.Tensor:
    """Full ancestral DDPM sampling with CFG over every train timestep,
    from ``num_train_timesteps - 1`` down to 0.  With a context and
    ``guidance_scale`` > 1 each step evaluates the zeros-context half and
    the context half in one batch, ``eps_u + g (eps_c - eps_u)``.  The
    starting noise is ``x0`` or drawn from ``generator``; step i's noise is
    ``noises[i]`` or drawn after the previous step's.

    The counterpart of the JAX package's one ``lax.scan``: every step reads
    static buffers (``x``, the timestep as a 0-d device tensor the host
    fills, the step's noise, drawn outside the step in the eager loop's
    order), so on the card the first step runs eagerly (the warm-up capture
    needs), the second is captured into a CUDA graph and every step is a
    replay of it, with its launches counted (``ops.launches``).  The
    schedule's tables live on the card and nothing is read back to the
    host.  On the CPU the same static-buffer step runs eagerly.  A failed
    capture or replay raises."""
    n, x0, step, noise_of = _sampler_setup(model, shape, generator, context, guidance_scale, schedule_config,
                                           x0, noises)
    dev = x0.device
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None
    if cuda:
        side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
        x = x0.clone()
        t = torch.zeros((), dtype=torch.long, device=dev)
        noise = torch.empty_like(x)
        graph = counts = None

        def body():
            x.copy_(step(x, t, noise))

        for i in range(n):
            t.fill_(n - 1 - i)
            noise.copy_(noise_of(i))
            if graph is None and cuda and i > 0:
                graph, counts = launches.capture(body)
            if graph is not None:
                launches.replay(graph, counts)
            else:
                body()
    if cuda:  # the graph and its pool go with this frame: let its replays finish first
        torch.cuda.current_stream(dev).wait_stream(side)
        side.synchronize()
    return x


@torch.no_grad()
def _sample_latents_eager(
    model: nn.Module,
    shape,
    generator: Optional[torch.Generator] = None,
    context: Optional[torch.Tensor] = None,
    guidance_scale: float = 7.5,
    schedule_config: SchedulerConfig = LATENT_SCHEDULE,
    x0: Optional[torch.Tensor] = None,
    noises=None,
) -> torch.Tensor:
    """``sample_latents``' plain version: the eager loop, one step at a
    time, each timestep a view of a device table; the replayed sampler is
    held against it, bit for bit."""
    n, x, step, noise_of = _sampler_setup(model, shape, generator, context, guidance_scale, schedule_config,
                                          x0, noises)
    timesteps = torch.arange(n - 1, -1, -1, device=x.device)
    for i in range(n):
        x = step(x, timesteps[i], noise_of(i))
    return x


def save_simple_checkpoint(model: nn.Module, path: str) -> int:
    """Write every parameter of ``model`` under its ``/``-joined Flax key
    (``params/conv_in/kernel``, ...) in the Flax layout and its own dtype:
    the file the JAX package's ``save_simple_checkpoint`` writes for the
    same tree.  Returns the bytes written."""
    from i2v_adapter_tpu_torch.training.checkpoint import _write_atomic, flax_tensors

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return _write_atomic(flax_tensors(model, prefix="params"), path)


def load_simple_checkpoint(path: str, model: Optional[nn.Module] = None) -> dict:
    """The checkpoint as a nested Flax tree of numpy arrays (``{"params":
    ...}``, as the JAX ``load_simple_checkpoint`` returns it); with
    ``model``, also loaded into it (strict)."""
    from i2v_adapter_tpu_torch.utils.safetensors_io import load_file

    tree = convert._unflatten(load_file(path))
    if model is not None:
        convert.load_flax_params(model, tree)
    return tree


__all__ = [
    "LATENT_SCHEDULE",
    "make_latent_train_step",
    "make_video_latent_train_step",
    "sample_latents",
    "save_simple_checkpoint",
    "load_simple_checkpoint",
    "SimpleUNet",
    "SimpleUNet3D",
]
