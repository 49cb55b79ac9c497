"""Functional DDIM sampler (diffusers ``DDIMScheduler`` semantics with
clip_sample=False, timestep_spacing='linspace', steps_offset=1).

Timestep selection is host-side numpy.  ``prev = t - T // steps`` is kept
as the reference has it: with 'linspace' spacing it is not the next array
timestep, and that is reproduced, not fixed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from i2v_adapter_tpu_torch.config import SchedulerConfig
from i2v_adapter_tpu_torch.schedulers.schedule import (
    NoiseSchedule,
    _broadcast,
    _lookup,
    predict_x0_and_eps,
)


def ddim_timesteps(config: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending inference timesteps."""
    n = config.num_train_timesteps
    if num_inference_steps > n:
        raise ValueError(f"num_inference_steps {num_inference_steps} > {n}")
    if config.timestep_spacing == "linspace":
        ts = np.linspace(0, n - 1, num_inference_steps).round()[::-1].copy().astype(np.int64)
    elif config.timestep_spacing == "leading":
        step_ratio = n // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
        ts = ts.astype(np.int64) + config.steps_offset
    elif config.timestep_spacing == "trailing":
        step_ratio = n / num_inference_steps
        ts = np.round(np.arange(n, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep_spacing: {config.timestep_spacing}")
    return ts


def truncate_timesteps(timesteps: np.ndarray, num_inference_steps: int, strength: float) -> np.ndarray:
    """Drop the leading (1 - strength) fraction of the schedule."""
    init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
    t_start = max(num_inference_steps - init_timestep, 0)
    return timesteps[t_start:]


def ddim_schedule_arrays(
    config: SchedulerConfig, num_inference_steps: int, strength: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps, prev_timesteps) for a possibly truncated DDIM run."""
    ts = truncate_timesteps(ddim_timesteps(config, num_inference_steps), num_inference_steps, strength)
    return ts, ts - config.num_train_timesteps // num_inference_steps


def ddim_step(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    timestep,
    prev_timestep,
    sample: torch.Tensor,
    eta: float = 0.0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One x_t -> x_{t-dt} DDIM update in fp32; a negative
    ``prev_timestep`` selects final_alpha_cumprod.  ``eta > 0`` needs
    ``noise`` (the caller draws it)."""
    dev = sample.device
    t = torch.as_tensor(timestep, dtype=torch.long)
    tp = torch.as_tensor(prev_timestep, dtype=torch.long)
    alpha_prod_t = _lookup(schedule.alphas_cumprod, t, dev)
    alpha_prod_prev = torch.where(
        tp.to(dev) >= 0,
        _lookup(schedule.alphas_cumprod, torch.clamp(tp, min=0), dev),
        schedule.final_alpha_cumprod.to(dev),
    )
    alpha_prod_t = _broadcast(alpha_prod_t, sample.ndim).float()
    alpha_prod_prev = _broadcast(alpha_prod_prev, sample.ndim).float()

    x0, eps = predict_x0_and_eps(schedule, model_output.float(), sample.float(), alpha_prod_t)
    beta_prod_prev = 1.0 - alpha_prod_prev
    if eta > 0.0:
        beta_prod_t = 1.0 - alpha_prod_t
        variance = (beta_prod_prev / beta_prod_t) * (1.0 - alpha_prod_t / alpha_prod_prev)
        std = eta * torch.sqrt(variance)
    else:
        std = torch.zeros_like(alpha_prod_prev)
    prev_sample = torch.sqrt(alpha_prod_prev) * x0 + torch.sqrt(beta_prod_prev - std**2) * eps
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires noise")
        prev_sample = prev_sample + std * noise.float()
    return prev_sample.to(sample.dtype)
