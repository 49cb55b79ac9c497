"""Primitives of the from-scratch latent-diffusion model zoo.

The port of the JAX package's ``models/simple/blocks.py``: GroupNorm-GELU
ResBlocks with timestep injection (2-D, and 3-D for the temporal stack),
factorised spatial / temporal attention blended by a learned
``AlphaBlender``, and the sinusoidal embedding.  Activations are NHWC /
NTHWC; parameter names are the Flax module names, so
``utils.convert.load_flax_params`` / ``to_flax_tree`` carry weights both
ways.  Flax's defaults are kept: ``nn.gelu`` is the tanh approximation and
LayerNorm / GroupNorm take eps 1e-6.

Flax infers input widths at ``init``; these modules take them at
construction (``in_channels``, ``context_dim``, ``temb_channels``).  A block
built without ``context_dim`` has no cross-attention, as a Flax block
initialised without a context has none.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from i2v_adapter_tpu_torch.models.layers import ConvNHWC, GroupNorm, LayerNorm, Linear
from i2v_adapter_tpu_torch.ops.attention import dot_product_attention

FLAX_EPS = 1e-6


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``nn.gelu`` default (``approximate=True``)."""
    return F.gelu(x, approximate="tanh")


def positional_emb(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin | cos] sinusoidal embedding, fp32 (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=positions.device) / half)
    args = positions.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class AlphaBlender(nn.Module):
    """Learned (or fixed) sigmoid mix of the spatial and temporal branches;
    ``image_only`` forces the spatial branch (alpha = 1).  alpha is cast to
    the activations' dtype before the mix."""

    def __init__(self, alpha: float = 0.5, learned: bool = True):
        super().__init__()
        self.alpha = alpha
        self.learned = learned
        if learned:
            self.mix_factor = nn.Parameter(torch.full((1,), float(alpha)))

    def forward(self, spatial, temporal, image_only: bool = False):
        if image_only:
            alpha = torch.ones((), device=spatial.device)
        elif self.learned:
            alpha = torch.sigmoid(self.mix_factor)[0]
        else:
            alpha = torch.full((), self.alpha, device=spatial.device)  # no host copy: capturable
        alpha = alpha.to(spatial.dtype)
        return alpha * spatial + (1.0 - alpha) * temporal


class BasicAttention(nn.Module):
    """q / k / v projections, attention, output projection.  The attention
    goes through ``ops.attention.dot_product_attention`` (the flash kernel
    K1 from 128 keys, its backward K3 from ``FLASH_BWD_MIN_NK`` keys) with
    the exact running max (``static_max=0.0``)."""

    def __init__(self, query_dim: int, heads: int, context_dim: Optional[int] = None,
                 dim_head: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head or query_dim // heads
        inner = heads * self.dim_head
        kv_dim = context_dim or query_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(kv_dim, inner, bias=False)
        self.to_v = Linear(kv_dim, inner, bias=False)
        self.to_out = Linear(inner, query_dim)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.heads, self.dim_head)  # noqa: E731
        out = dot_product_attention(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)),
                                    static_max=0.0)
        return self.to_out(out.reshape(x.shape[0], x.shape[1], -1))


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention (+ cross-attention when built with
    ``context_dim``) + a 4x GELU MLP, each with a residual.  Given no
    context, a block with cross-attention skips it, as the JAX models build
    and run no cross-attention without one."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        self.use_cross = context_dim is not None
        self.norm1 = LayerNorm(dim, eps=FLAX_EPS)
        self.self_attn = BasicAttention(dim, heads)
        if self.use_cross:
            self.norm2 = LayerNorm(dim, eps=FLAX_EPS)
            self.cross_attn = BasicAttention(dim, heads, context_dim)
        self.norm3 = LayerNorm(dim, eps=FLAX_EPS)
        self.mlp_in = Linear(dim, 4 * dim)
        self.mlp_out = Linear(4 * dim, dim)

    def forward(self, x, context=None):
        x = x + self.self_attn(self.norm1(x))
        if context is not None:
            if not self.use_cross:
                raise ValueError("a context was given to a block built without context_dim")
            x = x + self.cross_attn(self.norm2(x), context)
        return x + self.mlp_out(gelu_tanh(self.mlp_in(self.norm3(x))))


class VideoTransformer(nn.Module):
    """Factorised spatial -> temporal attention with a frame-position MLP
    embedding, merged by an ``AlphaBlender``, plus the residual.  Input
    (B*T, H, W, C) with ``num_frames`` = T; the temporal block attends over
    the T frames of each pixel (T keys, plain math)."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.spatial = BasicTransformerBlock(channels, heads)
        self.pos_mlp_in = Linear(channels, 4 * channels)
        self.pos_mlp_out = Linear(4 * channels, channels)
        self.temporal = BasicTransformerBlock(channels, heads)
        self.blender = AlphaBlender()

    def forward(self, x, *, num_frames: int, image_only: bool = False):
        bt, h, w, c = x.shape
        b = bt // num_frames
        spatial = self.spatial(x.reshape(bt, h * w, c))
        pos = positional_emb(torch.arange(num_frames, device=x.device), c)
        pos = self.pos_mlp_out(F.silu(self.pos_mlp_in(pos)))
        t_tokens = spatial.reshape(b, num_frames, h * w, c).transpose(1, 2).reshape(b * h * w, num_frames, c)
        temporal = self.temporal(t_tokens + pos[None].to(t_tokens.dtype))
        temporal = temporal.reshape(b, h * w, num_frames, c).transpose(1, 2).reshape(bt, h * w, c)
        return self.blender(spatial, temporal, image_only).reshape(bt, h, w, c) + x


class ConvNTHWC(nn.Conv3d):
    """``nn.Conv3d`` (OITHW weights) applied to channel-last (N, T, H, W, C)
    activations, in the input's dtype."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, self.stride, self.padding).permute(0, 2, 3, 4, 1)


def _groups(groups: int, channels: int) -> int:
    """The largest divisor of ``channels`` that is at most ``groups``."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def _conv(dims: int, cin: int, cout: int, kernel: Sequence[int]) -> nn.Module:
    """A SAME-padded stride-1 conv of odd ``kernel`` in ``dims`` dimensions."""
    padding = tuple(k // 2 for k in kernel)
    cls = ConvNHWC if dims == 2 else ConvNTHWC
    return cls(cin, cout, tuple(kernel), padding=padding)


class ResBlock(nn.Module):
    """GroupNorm-GELU double conv with timestep-MLP injection, 2-D (NHWC)
    or 3-D (NTHWC, kernel (3,3,3) by default) by ``dims``; a 1x1 shortcut
    where the width changes."""

    def __init__(self, in_channels: int, out_channels: int, dims: int = 2, groups: int = 8,
                 kernel: Optional[Sequence[int]] = None, temb_channels: Optional[int] = None):
        super().__init__()
        if dims not in (2, 3):
            raise ValueError(f"dims must be 2 or 3, got {dims}")
        k = tuple(kernel) if kernel is not None else (3,) * dims
        self.norm1 = GroupNorm(_groups(groups, in_channels), in_channels, FLAX_EPS)
        self.conv1 = _conv(dims, in_channels, out_channels, k)
        if temb_channels is not None:
            self.temb_proj = Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(_groups(groups, out_channels), out_channels, FLAX_EPS)
        self.conv2 = _conv(dims, out_channels, out_channels, k)
        if in_channels != out_channels:
            self.shortcut = _conv(dims, in_channels, out_channels, (1,) * dims)

    def forward(self, x, temb=None):
        h = self.conv1(gelu_tanh(self.norm1(x)))
        if temb is not None:
            t = self.temb_proj(gelu_tanh(temb))
            h = h + t.reshape(t.shape[:1] + (1,) * (x.ndim - 2) + t.shape[1:])
        h = self.conv2(gelu_tanh(self.norm2(h)))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return x + h


class VideoResBlock(nn.Module):
    """Spatial ResBlock + a temporal (3,1,1) 3-D ResBlock over the frames,
    blended by an ``AlphaBlender``.  Input (B*T, H, W, C); the temporal
    block takes frame 0's row of ``temb``."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 8,
                 temb_channels: Optional[int] = None):
        super().__init__()
        self.spatial = ResBlock(in_channels, out_channels, dims=2, groups=groups, temb_channels=temb_channels)
        self.time_stack = ResBlock(out_channels, out_channels, dims=3, groups=groups, kernel=(3, 1, 1),
                                   temb_channels=temb_channels)
        self.blender = AlphaBlender()

    def forward(self, x, temb=None, *, num_frames: int, image_only: bool = False):
        b = x.shape[0] // num_frames
        spatial = self.spatial(x, temb)
        vid = spatial.reshape((b, num_frames) + spatial.shape[1:])
        t3 = temb.reshape(b, num_frames, -1)[:, 0] if temb is not None else None
        temporal = self.time_stack(vid, t3).reshape(spatial.shape)
        return self.blender(spatial, temporal, image_only)
