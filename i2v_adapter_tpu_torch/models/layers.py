"""Primitive layers of the SD1.5-shaped UNet and VAE.

Activations are channel-last, ``(N, H, W, C)``, as in the JAX package.  A
convolution hands ``F.conv2d`` the NCHW-shaped permuted view, which is a
``channels_last`` tensor, so no copy is made on either side of it.
Submodule names follow the Flax module names (norm1/conv1/time_emb_proj/...)
so that ``utils.convert.load_flax_params`` maps parameters mechanically.

Compute dtype is apart from storage dtype, as Flax's ``dtype=`` makes it:
``Linear``, ``LayerNorm`` and ``ConvNHWC`` cast their weights to the
activation's dtype at use, so fp32 trainables and bf16 (or fp32) frozen
weights run one bf16 forward and the gradient reaches the fp32 master
through the cast.  ``GroupNorm`` computes in fp32 and returns the input's
dtype.  Where the two dtypes agree the casts are no-ops.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def group_norm(x, num_groups: int, eps: float, weight, bias) -> torch.Tensor:
    """GroupNorm of a channel-last tensor ``(N, ..., C)``: statistics per
    sample and group over every non-batch position, in fp32."""
    shape = x.shape
    c = shape[-1]
    xf = x.reshape(shape[0], -1, num_groups, c // num_groups).float()
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, unbiased=False)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(shape)
    return (y * weight.float() + bias.float()).to(x.dtype)


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return group_norm(x, self.num_groups, self.eps, self.weight, self.bias)


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computing in the input's dtype."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, _cast(self.weight, x.dtype),
                            _cast(self.bias, x.dtype), self.eps)


class ConvNHWC(nn.Conv2d):
    """``nn.Conv2d`` (OIHW weights) applied to channel-last activations, in
    the input's dtype."""

    def forward(self, x):
        w, b = self.weight.to(x.dtype), _cast(self.bias, x.dtype)
        if self.kernel_size == (1, 1) and self.stride == (1, 1):
            return F.linear(x, w.flatten(1), b)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers ``Timesteps``), fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting the sinusoidal embedding."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


class ResnetBlock2D(nn.Module):
    """GroupNorm-SiLU-Conv x2 with timestep injection and 1x1 shortcut."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int] = None,
        groups: int = 32,
        eps: float = 1e-5,
    ):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps)
        self.conv1 = ConvNHWC(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps)
        self.conv2 = ConvNHWC(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = ConvNHWC(in_channels, out_channels, 1)
        self.use_time_emb = temb_channels is not None
        self.use_shortcut = in_channels != out_channels

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.use_time_emb:
            if temb is None:
                raise ValueError("temb required")
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.use_shortcut:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv; ``asymmetric_pad`` is the VAE encoder's (0,1,0,1)
    padding, the UNet pads 1 on every side."""

    def __init__(self, in_channels: int, out_channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = ConvNHWC(
            in_channels, out_channels, 3, stride=2, padding=0 if asymmetric_pad else 1
        )

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest-neighbour 2x upsample then 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = ConvNHWC(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
        return self.conv(x.permute(0, 2, 3, 1))
