"""Gaussian blur on channel-last feature maps (the PIA prior's blur).

torchvision's GaussianBlur convention: a normalised 1-D kernel applied along
rows then columns, reflect padding.  Sigma is explicit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_kernel1d(kernel_size: int, sigma: float, dtype, device) -> torch.Tensor:
    half = (kernel_size - 1) * 0.5
    x = torch.linspace(-half, half, kernel_size, dtype=torch.float32, device=device)
    pdf = torch.exp(-0.5 * (x / sigma) ** 2)
    return (pdf / pdf.sum()).to(dtype)


def gaussian_blur(image: torch.Tensor, kernel_size: int = 3, sigma: float = 1.0) -> torch.Tensor:
    """Separable depthwise blur of ``(..., H, W, C)``, reflect-padded."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    k1 = _gaussian_kernel1d(kernel_size, float(sigma), image.dtype, image.device)
    pad = kernel_size // 2
    batch_shape = image.shape[:-3]
    h, w, c = image.shape[-3:]
    x = image.reshape(-1, h, w, c).permute(0, 3, 1, 2)  # NCHW view
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    x = F.conv2d(x, k1.view(1, 1, kernel_size, 1).expand(c, 1, kernel_size, 1), groups=c)
    x = F.conv2d(x, k1.view(1, 1, 1, kernel_size).expand(c, 1, 1, kernel_size), groups=c)
    return x.permute(0, 2, 3, 1).reshape(*batch_shape, h, w, c)
