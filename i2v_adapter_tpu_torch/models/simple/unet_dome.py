"""Fixed-size DDPM UNet, the "dome" variant (the JAX package's
``models/simple/unet_dome.py``).

A compact 64-channel UNet with hard-coded attention at every level after
the input: inc DoubleConv(3->64); down 64->128, 128->256, 256->256, each
followed by token self-attention; a 256->512->512->256 bottleneck; up
512->128, 256->64, 128->64 with bilinear 2x upsampling and self-attention;
a 1x1 output conv.  NHWC, fp32, for (B, 64, 64, c_in) inputs.

Its attention is Flax's ``MultiHeadDotProductAttention``, which the JAX
package leaves to XLA, so here it is plain math (``ops.attention.
xla_attention``), not a kernel.  The projections keep Flax's
``DenseGeneral`` layouts: q / k / v kernels (C, heads, D), the output kernel
(heads, D, C).  GELU is exact here; the norms take eps 1e-6.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from i2v_adapter_tpu_torch.device import DeviceLike, resolve_device
from i2v_adapter_tpu_torch.models.layers import ConvNHWC, GroupNorm, LayerNorm, Linear
from i2v_adapter_tpu_torch.models.simple.blocks import FLAX_EPS
from i2v_adapter_tpu_torch.models.simple.unet2d import max_pool2
from i2v_adapter_tpu_torch.ops.attention import xla_attention


def dome_time_encoding(t: torch.Tensor, channels: int) -> torch.Tensor:
    """[sin | cos] of t against ``channels // 2`` inverse frequencies, fp32."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, channels, 2, dtype=torch.float32, device=t.device) / channels))
    ang = t.float()[:, None] * inv_freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class DenseGeneral(nn.Module):
    """Flax ``DenseGeneral``: contracts the last ``len(in_shape)`` axes with
    ``kernel (*in_shape, *out_shape)`` and adds ``bias (*out_shape)``.  The
    parameters keep the Flax names and layouts (``flax_layout``), which the
    weight carrier moves as they are."""

    flax_layout = True

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int]):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        fan_in = math.prod(self.in_shape)
        self.kernel = nn.Parameter(torch.randn(*self.in_shape, *self.out_shape) / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))

    def forward(self, x):
        lead = x.shape[: x.ndim - len(self.in_shape)]
        w = self.kernel.to(x.dtype).reshape(math.prod(self.in_shape), -1)
        y = x.reshape(*lead, -1) @ w
        return y.reshape(*lead, *self.out_shape) + self.bias.to(x.dtype)


class DomeMultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` (self-attention, qkv features =
    the input width) on plain math."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        d = channels // heads
        self.query = DenseGeneral((channels,), (heads, d))
        self.key = DenseGeneral((channels,), (heads, d))
        self.value = DenseGeneral((channels,), (heads, d))
        self.out = DenseGeneral((heads, d), (channels,))

    def forward(self, x):
        return self.out(xla_attention(self.query(x), self.key(x), self.value(x)))


class DoubleConv(nn.Module):
    """conv3x3 -> GroupNorm(1) -> GELU -> conv3x3 -> GroupNorm(1), or
    gelu(x + that) when ``residual``."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int = 0, residual: bool = False):
        super().__init__()
        mid = mid_channels or out_channels
        self.residual = residual
        self.conv1 = ConvNHWC(in_channels, mid, 3, padding=1, bias=False)
        self.norm1 = GroupNorm(1, mid, FLAX_EPS)
        self.conv2 = ConvNHWC(mid, out_channels, 3, padding=1, bias=False)
        self.norm2 = GroupNorm(1, out_channels, FLAX_EPS)

    def forward(self, x):
        h = self.norm2(self.conv2(F.gelu(self.norm1(self.conv1(x)))))
        return F.gelu(x + h) if self.residual else h


class DomeSelfAttention(nn.Module):
    """LN -> 4-head self-attention residual, LN -> GELU MLP residual, over
    the H*W tokens of (B, H, W, C)."""

    def __init__(self, channels: int, heads: int = 4):
        super().__init__()
        self.ln = LayerNorm(channels, eps=FLAX_EPS)
        self.mha = DomeMultiHeadAttention(channels, heads)
        self.ff_ln = LayerNorm(channels, eps=FLAX_EPS)
        self.ff_1 = Linear(channels, channels)
        self.ff_2 = Linear(channels, channels)

    def forward(self, x):
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = tokens + self.mha(self.ln(tokens))
        tokens = tokens + self.ff_2(F.gelu(self.ff_1(self.ff_ln(tokens))))
        return tokens.reshape(b, h, w, c)


class DomeDown(nn.Module):
    """maxpool/2 -> residual DoubleConv -> DoubleConv, + a SiLU-MLP time
    embedding broadcast over space."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int):
        super().__init__()
        self.res = DoubleConv(in_channels, in_channels, residual=True)
        self.proj = DoubleConv(in_channels, out_channels)
        self.emb = Linear(time_dim, out_channels)

    def forward(self, x, temb):
        x = self.proj(self.res(max_pool2(x)))
        return x + self.emb(F.silu(temb))[:, None, None, :]


class DomeUp(nn.Module):
    """bilinear 2x upsample -> [skip, x] -> residual DoubleConv ->
    DoubleConv(mid = in / 2), + the time embedding.  ``in_channels`` counts
    the skip's channels too.  The upsampling is ``jax.image.resize``'s
    "bilinear" at scale 2: half-pixel centres, the weights that fall
    outside renormalised away, which is ``align_corners=False``'s clamped
    edge."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int):
        super().__init__()
        self.res = DoubleConv(in_channels, in_channels, residual=True)
        self.proj = DoubleConv(in_channels, out_channels, mid_channels=in_channels // 2)
        self.emb = Linear(time_dim, out_channels)

    def forward(self, x, skip, temb):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
        x = self.proj(self.res(torch.cat([skip, x], dim=-1)))
        return x + self.emb(F.silu(temb))[:, None, None, :]


class SimpleUNetDome(nn.Module):
    """The fixed-topology DDPM UNet: (B, 64, 64, c_in) NHWC + integer
    timesteps -> (B, 64, 64, c_out)."""

    def __init__(self, c_out: int = 3, time_dim: int = 256, c_in: int = 3, device: DeviceLike = None):
        super().__init__()
        self.time_dim = time_dim
        with torch.device(resolve_device(device)):
            self.inc = DoubleConv(c_in, 64)
            self.down1, self.sa1 = DomeDown(64, 128, time_dim), DomeSelfAttention(128)
            self.down2, self.sa2 = DomeDown(128, 256, time_dim), DomeSelfAttention(256)
            self.down3, self.sa3 = DomeDown(256, 256, time_dim), DomeSelfAttention(256)
            self.bot1, self.bot2, self.bot3 = DoubleConv(256, 512), DoubleConv(512, 512), DoubleConv(512, 256)
            self.up1, self.sa4 = DomeUp(512, 128, time_dim), DomeSelfAttention(128)
            self.up2, self.sa5 = DomeUp(256, 64, time_dim), DomeSelfAttention(64)
            self.up3, self.sa6 = DomeUp(128, 64, time_dim), DomeSelfAttention(64)
            self.outc = ConvNHWC(64, c_out, 1)

    def forward(self, x, t):
        temb = dome_time_encoding(t, self.time_dim)
        x1 = self.inc(x)
        x2 = self.sa1(self.down1(x1, temb))
        x3 = self.sa2(self.down2(x2, temb))
        x4 = self.sa3(self.down3(x3, temb))
        x4 = self.bot3(self.bot2(self.bot1(x4)))
        x = self.sa4(self.up1(x4, x3, temb))
        x = self.sa5(self.up2(x, x2, temb))
        x = self.sa6(self.up3(x, x1, temb))
        return self.outc(x)
