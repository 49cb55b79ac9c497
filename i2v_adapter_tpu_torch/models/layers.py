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
dtype, on the card's kernel where no gradient is recorded (``group_norm``).
Where the two dtypes agree the casts are no-ops.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from i2v_adapter_tpu_torch.ops.conv3x3 import gn_silu_conv3x3
from i2v_adapter_tpu_torch.ops.int8 import drop_weights, int8_conv, prepare_weights
from i2v_adapter_tpu_torch.ops.norms import (fold_gn_affine, fused_group_norm_applies, group_norm_fused,
                                              group_norm_plain)


def group_norm(x, num_groups: int, eps: float, weight, bias, silu: bool = False, absmax: bool = False):
    """GroupNorm of a channel-last tensor ``(N, ..., C)``: statistics per
    sample and group over every non-batch position, in fp32; ``silu``
    applies SiLU to the result.  Where autograd records nothing and the
    card's kernel takes the operands (``ops.norms.fused_group_norm_applies``)
    it runs ``ops.norms.group_norm_fused``, the SiLU folded in; everywhere
    else the composition ``ops.norms.group_norm_plain``.  With ``absmax``
    returns ``(out, max |out|)``, the second a 0-d fp32 tensor from the
    kernel and None from the composition."""
    if fused_group_norm_applies(x, num_groups, weight, bias):
        return group_norm_fused(x, num_groups, eps, weight, bias, silu=silu, absmax=absmax)
    y = group_norm_plain(x, num_groups, eps, weight, bias, silu)
    return (y, None) if absmax else y


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, silu: bool = False, absmax: bool = False):
        return group_norm(x, self.num_groups, self.eps, self.weight, self.bias, silu, absmax)


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
    """GroupNorm-SiLU-Conv x2 with timestep injection and 1x1 shortcut.

    ``conv_impl``: ``'auto'`` and ``'xla'`` run each norm -> SiLU -> conv
    stage as GroupNorm, SiLU and the library convolution; ``'pallas'`` (the
    JAX package's name for its fused path) folds the norm's statistics and
    affine into per-(sample, channel) vectors and runs the stage as one
    kernel, ``ops.conv3x3.gn_silu_conv3x3``.  ``int8`` (serving) runs each
    3x3 conv as ``ops.int8.int8_conv`` after the GroupNorm and SiLU, and wins
    over ``conv_impl`` as in the JAX package; the 1x1 shortcut stays exact.
    The parameters are the same ``norm1/conv1/norm2/conv2`` under every
    setting, so state dicts and Flax trees interchange."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int] = None,
        groups: int = 32,
        eps: float = 1e-5,
        conv_impl: str = "auto",
        int8: bool = False,
    ):
        super().__init__()
        if conv_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown conv_impl: {conv_impl}")
        self.conv_impl = conv_impl
        self.int8 = int8
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

    def _norm_silu_conv(self, norm: GroupNorm, conv: ConvNHWC, h):
        if self.int8:
            # the kernel's abs-max of its own output spares the conv's read
            # (None from the composition: the conv reads its own)
            a, peak = norm(h, silu=True, absmax=True)
            return int8_conv(a, conv.weight.permute(2, 3, 1, 0), conv.bias, absmax=peak)
        if self.conv_impl != "pallas":
            return conv(norm(h, silu=True))
        a, s = fold_gn_affine(h, norm.num_groups, norm.eps, norm.weight, norm.bias)
        # an HWIO view of the OIHW parameter: the kernel reads that storage
        # as it is (see ops/conv3x3.py), so nothing is repacked per call
        kernel = conv.weight.to(h.dtype).permute(2, 3, 1, 0)
        return gn_silu_conv3x3(h, a, s, kernel, conv.bias)

    def forward(self, x, temb=None):
        h = self._norm_silu_conv(self.norm1, self.conv1, x)
        if self.use_time_emb:
            if temb is None:
                raise ValueError("temb required")
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self._norm_silu_conv(self.norm2, self.conv2, h)
        if self.use_shortcut:
            x = self.conv_shortcut(x)
        return x + h


def _conv(conv: ConvNHWC, x, int8: bool):
    """``conv(x)``, or its int8 version (``ops.int8.int8_conv``) on the same
    parameters, quantised once per weights version."""
    if not int8:
        return conv(x)
    return int8_conv(x, conv.weight.permute(2, 3, 1, 0), conv.bias, stride=conv.stride[0],
                     padding=conv.padding[0])


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv; ``asymmetric_pad`` is the VAE encoder's (0,1,0,1)
    padding, the UNet pads 1 on every side.  ``int8``: the conv in int8."""

    def __init__(self, in_channels: int, out_channels: int, asymmetric_pad: bool = False,
                 int8: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.int8 = int8
        self.conv = ConvNHWC(
            in_channels, out_channels, 3, stride=2, padding=0 if asymmetric_pad else 1
        )

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return _conv(self.conv, x, self.int8)


class Upsample2D(nn.Module):
    """Nearest-neighbour 2x upsample then 3x3 conv (in int8 with ``int8``)."""

    def __init__(self, in_channels: int, out_channels: int, int8: bool = False):
        super().__init__()
        self.int8 = int8
        self.conv = ConvNHWC(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
        return _conv(self.conv, x.permute(0, 2, 3, 1), self.int8)


def int8_sites(*modules: nn.Module) -> list:
    """The convs that run in int8 under ``modules``: both 3x3 convs of every
    int8 ``ResnetBlock2D`` and the conv of every int8 ``Downsample2D`` /
    ``Upsample2D``, in module order."""
    sites = []
    for module in modules:
        for m in module.modules():
            if isinstance(m, ResnetBlock2D) and m.int8:
                sites += [m.conv1, m.conv2]
            elif isinstance(m, (Downsample2D, Upsample2D)) and m.int8:
                sites.append(m.conv)
    return sites


def prepare_int8(*modules: nn.Module) -> int:
    """Quantise the weights of every int8 site under ``modules`` whose
    cached pair is missing or stale, in one grouped launch on the card
    (``ops.int8.prepare_weights``); returns how many were quantised."""
    return prepare_weights([conv.weight for conv in int8_sites(*modules)])


def set_int8(module: nn.Module, enabled: bool) -> None:
    """Switch every ResnetBlock2D / Downsample2D / Upsample2D under
    ``module`` to int8 (or back to exact) convs; parameters are untouched.
    Switching off drops the sites' quantised weights."""
    if not enabled:
        drop_weights([conv.weight for conv in int8_sites(module)])
    for m in module.modules():
        if isinstance(m, (ResnetBlock2D, Downsample2D, Upsample2D)):
            m.int8 = enabled
