"""Noise schedule as a few precomputed tensors plus pure functions."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from i2v_adapter_tpu_torch.config import SchedulerConfig


class NoiseSchedule(NamedTuple):
    """Precomputed diffusion schedule (fp32 tensors of length T)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    # used by DDIM when stepping past timestep 0
    final_alpha_cumprod: torch.Tensor
    num_train_timesteps: int
    prediction_type: str
    clip_sample: bool
    clip_sample_range: float


def make_schedule(config: SchedulerConfig, device=None) -> NoiseSchedule:
    n = config.num_train_timesteps
    # float64 cumulative product on the host, then fp32 (diffusers' tables)
    if config.beta_schedule == "scaled_linear":
        betas = np.linspace(config.beta_start**0.5, config.beta_end**0.5, n, dtype=np.float64) ** 2
    elif config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, n, dtype=np.float64)
    else:
        raise ValueError(f"unknown beta_schedule: {config.beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    final = 1.0 if config.set_alpha_to_one else alphas_cumprod[0]
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
    return NoiseSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        final_alpha_cumprod=f32(final),
        num_train_timesteps=n,
        prediction_type=config.prediction_type,
        clip_sample=config.clip_sample,
        clip_sample_range=config.clip_sample_range,
    )


def _broadcast(coeff: torch.Tensor, target_ndim: int) -> torch.Tensor:
    return coeff.reshape(coeff.shape + (1,) * (target_ndim - coeff.ndim))


def _lookup(table: torch.Tensor, timesteps, device) -> torch.Tensor:
    idx = torch.as_tensor(timesteps, dtype=torch.long, device=table.device)
    return table[idx].to(device)


def add_noise(schedule: NoiseSchedule, sample, noise, timesteps) -> torch.Tensor:
    """q(x_t | x_0) = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps, with a
    (batch,) timestep broadcast over the remaining axes."""
    abar = _lookup(schedule.alphas_cumprod, timesteps, sample.device).to(sample.dtype)
    sqrt_abar = _broadcast(torch.sqrt(abar), sample.ndim)
    sqrt_one_minus = _broadcast(torch.sqrt(1.0 - abar), sample.ndim)
    return sqrt_abar * sample + sqrt_one_minus * noise


def get_velocity(schedule: NoiseSchedule, sample, noise, timesteps) -> torch.Tensor:
    """v-prediction target: sqrt(abar) eps - sqrt(1 - abar) x_0."""
    abar = _lookup(schedule.alphas_cumprod, timesteps, sample.device).to(sample.dtype)
    sqrt_abar = _broadcast(torch.sqrt(abar), sample.ndim)
    sqrt_one_minus = _broadcast(torch.sqrt(1.0 - abar), sample.ndim)
    return sqrt_abar * noise - sqrt_one_minus * sample


def compute_snr(schedule: NoiseSchedule, timesteps) -> torch.Tensor:
    """Signal-to-noise ratio abar / (1 - abar) per timestep (SNR-gamma loss)."""
    abar = _lookup(schedule.alphas_cumprod, timesteps, schedule.alphas_cumprod.device)
    return abar / (1.0 - abar)


def predict_x0_and_eps(schedule: NoiseSchedule, model_output, sample, alpha_prod_t):
    """(x0_hat, eps_hat) under the configured prediction type."""
    beta_prod_t = 1.0 - alpha_prod_t
    sqrt_a, sqrt_b = torch.sqrt(alpha_prod_t), torch.sqrt(beta_prod_t)
    if schedule.prediction_type == "epsilon":
        eps = model_output
        x0 = (sample - sqrt_b * eps) / sqrt_a
    elif schedule.prediction_type == "v_prediction":
        x0 = sqrt_a * sample - sqrt_b * model_output
        eps = sqrt_a * model_output + sqrt_b * sample
    elif schedule.prediction_type == "sample":
        x0 = model_output
        eps = (sample - sqrt_a * x0) / sqrt_b
    else:
        raise ValueError(f"unknown prediction_type: {schedule.prediction_type}")
    if schedule.clip_sample:
        r = schedule.clip_sample_range
        x0 = torch.clamp(x0, -r, r)
        eps = (sample - sqrt_a * x0) / sqrt_b
    return x0, eps
