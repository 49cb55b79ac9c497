"""Functional ancestral DDPM step (diffusers ``DDPMScheduler.step``
semantics), the sampler of the latent trainers (``training/train_latent.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from i2v_adapter_tpu_torch.schedulers.schedule import NoiseSchedule, predict_x0_and_eps


def ddpm_step(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    timestep,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One ancestral x_t -> x_{t-1} update with fixed_small variance
    (clipped at 1e-20), in fp32; no noise is added at t = 0.  ``timestep``
    is an int or a (batch,) tensor, which may lie on the card: nothing is
    read back to the host."""
    table = schedule.alphas_cumprod
    t = torch.as_tensor(timestep, dtype=torch.long, device=table.device)
    alpha_prod_t = table[t]
    alpha_prod_prev = torch.where(t > 0, table[(t - 1).clamp(min=0)], torch.ones_like(alpha_prod_t))
    shape = t.shape + (1,) * (sample.ndim - t.ndim)
    alpha_prod_t = alpha_prod_t.reshape(shape).float().to(sample.device)
    alpha_prod_prev = alpha_prod_prev.reshape(shape).float().to(sample.device)
    beta_prod_t = 1.0 - alpha_prod_t
    beta_prod_prev = 1.0 - alpha_prod_prev
    current_alpha = alpha_prod_t / alpha_prod_prev
    current_beta = 1.0 - current_alpha

    sample32 = sample.float()
    x0, _ = predict_x0_and_eps(schedule, model_output.float(), sample32, alpha_prod_t)

    # mu_t coefficients (DDPM eq. 7)
    x0_coeff = torch.sqrt(alpha_prod_prev) * current_beta / beta_prod_t
    xt_coeff = torch.sqrt(current_alpha) * beta_prod_prev / beta_prod_t
    mean = x0_coeff * x0 + xt_coeff * sample32

    variance = torch.clamp(beta_prod_prev / beta_prod_t * current_beta, min=1e-20)
    if noise is None:
        noise = torch.zeros_like(sample32)
    positive = (t > 0).reshape(shape).to(sample.device)
    add = torch.where(positive, torch.sqrt(variance) * noise.float(), torch.zeros((), device=sample.device))
    return (mean + add).to(sample.dtype)
