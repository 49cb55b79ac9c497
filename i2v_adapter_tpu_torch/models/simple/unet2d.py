"""From-scratch 2-D latent UNet (the JAX package's ``models/simple/unet2d.py``).

Down / up levels of ResBlock (+ BasicTransformerBlock where
``attention_levels`` says) with 2x2 max-pool and nearest 2x upsampling, the
skips concatenated on the channel axis ([x, skip]).  NHWC; used by the
latent-image trainer (``training/train_latent.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from i2v_adapter_tpu_torch.device import DeviceLike, resolve_device
from i2v_adapter_tpu_torch.models.layers import ConvNHWC, GroupNorm, Linear
from i2v_adapter_tpu_torch.models.simple.blocks import FLAX_EPS, BasicTransformerBlock, ResBlock, positional_emb


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID, on (N, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of (N, H, W, C)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def attend(block: BasicTransformerBlock, h: torch.Tensor, context=None) -> torch.Tensor:
    """A transformer block over the H*W tokens of (N, H, W, C)."""
    b, hh, ww, c = h.shape
    return block(h.reshape(b, hh * ww, c), context).reshape(b, hh, ww, c)


def up_in_channels(widths: Tuple[int, ...]) -> list:
    """Input width of each up level's ResBlock, level i = 0..n-1: the level
    below's output (the mid block's for the top) plus level i's skip."""
    n = len(widths)
    return [(widths[i + 1] if i < n - 1 else widths[-1]) + widths[i] for i in range(n)]


class SimpleUNet(nn.Module):
    def __init__(self, widths: Tuple[int, ...] = (64, 128, 256),
                 attention_levels: Tuple[bool, ...] = (False, True, True), heads: int = 4,
                 context_dim: Optional[int] = None, out_channels: int = 4, in_channels: int = 4,
                 device: DeviceLike = None):
        super().__init__()
        self.widths, self.attention_levels = tuple(widths), tuple(attention_levels)
        self.heads, self.context_dim = heads, context_dim
        w0, temb = widths[0], 4 * widths[0]
        with torch.device(resolve_device(device)):
            self.temb_in = Linear(w0, temb)
            self.temb_out = Linear(temb, temb)
            self.conv_in = ConvNHWC(in_channels, w0, 3, padding=1)
            prev = w0
            for i, w in enumerate(widths):
                self.add_module(f"down_{i}_res", ResBlock(prev, w, temb_channels=temb))
                if attention_levels[i]:
                    self.add_module(f"down_{i}_attn", BasicTransformerBlock(w, heads, context_dim))
                prev = w
            self.mid_res1 = ResBlock(prev, prev, temb_channels=temb)
            self.mid_attn = BasicTransformerBlock(prev, heads, context_dim)
            self.mid_res2 = ResBlock(prev, prev, temb_channels=temb)
            for i, (w, cin) in enumerate(zip(widths, up_in_channels(widths))):
                self.add_module(f"up_{i}_res", ResBlock(cin, w, temb_channels=temb))
                if attention_levels[i]:
                    self.add_module(f"up_{i}_attn", BasicTransformerBlock(w, heads, context_dim))
            self.norm_out = GroupNorm(8, w0, FLAX_EPS)
            self.conv_out = ConvNHWC(w0, out_channels, 3, padding=1)

    def forward(self, x, timestep, context=None):
        """x (B, H, W, C), timestep (B,), context (B, L, D) or None."""
        temb = self.temb_out(F.silu(self.temb_in(positional_emb(timestep, self.widths[0]))))
        n = len(self.widths)
        x = self.conv_in(x)
        skips = [x]
        for i in range(n):
            x = getattr(self, f"down_{i}_res")(x, temb)
            if self.attention_levels[i]:
                x = attend(getattr(self, f"down_{i}_attn"), x, context)
            skips.append(x)
            if i < n - 1:
                x = max_pool2(x)
        x = self.mid_res1(x, temb)
        x = attend(self.mid_attn, x, context)
        x = self.mid_res2(x, temb)
        for i in reversed(range(n)):
            if i < n - 1:
                x = upsample2(x)
            x = getattr(self, f"up_{i}_res")(torch.cat([x, skips.pop()], dim=-1), temb)
            if self.attention_levels[i]:
                x = attend(getattr(self, f"up_{i}_attn"), x, context)
        return self.conv_out(F.silu(self.norm_out(x)))
