"""The EDM Euler sampler of Stable Video Diffusion (diffusers'
``EulerDiscreteScheduler`` with Karras sigmas, continuous timesteps and
v-prediction, no churn).

``euler_sigmas(config, n)`` gives the ``n + 1`` sigmas, Karras' ramp from
``sigma_max`` down to ``sigma_min`` (``rho`` 7) with 0 appended, and the
``n`` continuous timesteps ``c_noise = 0.25 ln sigma`` the UNet is fed;
both worked out in float64 and returned as fp32 tensors.  A step scales the
UNet's input by ``1 / sqrt(sigma^2 + 1)``, reads the denoised sample from
the v-prediction, ``x0 = -sigma / sqrt(sigma^2 + 1) v + x / (sigma^2 + 1)``,
and moves ``x`` along ``(x - x0) / sigma`` by ``sigma_next - sigma``
(``euler_step``).  The initial latents are unit noise times
``init_noise_sigma = sqrt(sigma_0^2 + 1)`` (the "leading" spacing's).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from i2v_adapter_tpu_torch.config import EulerSchedulerConfig


def karras_sigmas(config: EulerSchedulerConfig, n: int) -> np.ndarray:
    """The ``n`` Karras sigmas, float64, largest first."""
    ramp = np.linspace(0.0, 1.0, n, dtype=np.float64)
    lo, hi = config.sigma_min ** (1.0 / config.rho), config.sigma_max ** (1.0 / config.rho)
    return (hi + ramp * (lo - hi)) ** config.rho


def euler_sigmas(config: EulerSchedulerConfig, n: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sigmas (n + 1,), c_noise (n,))``, fp32 on ``device``."""
    sigmas = karras_sigmas(config, n)
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)  # noqa: E731
    return f32(np.append(sigmas, 0.0)), f32(0.25 * np.log(sigmas))


def init_noise_sigma(sigmas: torch.Tensor) -> torch.Tensor:
    return (sigmas[0] ** 2 + 1.0).sqrt()


def scale_model_input(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return x / (sigma ** 2 + 1.0).sqrt()


def euler_step(v: torch.Tensor, x: torch.Tensor, sigma: torch.Tensor, sigma_next: torch.Tensor) -> torch.Tensor:
    """One Euler step from ``sigma`` to ``sigma_next`` of ``x`` given the
    v-prediction ``v``, in the dtype of ``x``."""
    s2 = sigma ** 2 + 1.0
    x0 = -sigma / s2.sqrt() * v + x / s2
    return x + (x - x0) / sigma * (sigma_next - sigma)
