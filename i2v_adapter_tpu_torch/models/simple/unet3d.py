"""From-scratch video UNet (the JAX package's ``models/simple/unet3d.py``).

SimpleUNet's skeleton with VideoResBlocks and VideoTransformers, a cross-
attention block after each VideoTransformer when built with
``context_dim``, and the ``image_only`` switch (temporal branches blended
out) for joint image + video training.  Frames go into the batch:
(B, T, H, W, C) -> (B*T, H, W, C); the timestep embedding and the context
are repeated per frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from i2v_adapter_tpu_torch.device import DeviceLike, resolve_device
from i2v_adapter_tpu_torch.models.layers import ConvNHWC, GroupNorm, Linear
from i2v_adapter_tpu_torch.models.simple.blocks import (
    FLAX_EPS,
    BasicTransformerBlock,
    VideoResBlock,
    VideoTransformer,
    positional_emb,
)
from i2v_adapter_tpu_torch.models.simple.unet2d import attend, max_pool2, up_in_channels, upsample2


class SimpleUNet3D(nn.Module):
    def __init__(self, widths: Tuple[int, ...] = (64, 128, 256),
                 attention_levels: Tuple[bool, ...] = (False, True, True), heads: int = 4,
                 context_dim: Optional[int] = None, out_channels: int = 4, in_channels: int = 4,
                 device: DeviceLike = None):
        super().__init__()
        self.widths, self.attention_levels = tuple(widths), tuple(attention_levels)
        self.heads, self.context_dim, self.out_channels = heads, context_dim, out_channels
        w0, temb = widths[0], 4 * widths[0]
        cross = context_dim is not None

        def attention(name, w):
            self.add_module(f"{name}_attn", VideoTransformer(w, heads))
            if cross:
                self.add_module(f"{name}_cross", BasicTransformerBlock(w, heads, context_dim))

        with torch.device(resolve_device(device)):
            self.temb_in = Linear(w0, temb)
            self.temb_out = Linear(temb, temb)
            self.conv_in = ConvNHWC(in_channels, w0, 3, padding=1)
            prev = w0
            for i, w in enumerate(widths):
                self.add_module(f"down_{i}_res", VideoResBlock(prev, w, temb_channels=temb))
                if attention_levels[i]:
                    attention(f"down_{i}", w)
                prev = w
            self.mid_res1 = VideoResBlock(prev, prev, temb_channels=temb)
            attention("mid", prev)
            self.mid_res2 = VideoResBlock(prev, prev, temb_channels=temb)
            for i, (w, cin) in enumerate(zip(widths, up_in_channels(widths))):
                self.add_module(f"up_{i}_res", VideoResBlock(cin, w, temb_channels=temb))
                if attention_levels[i]:
                    attention(f"up_{i}", w)
            self.norm_out = GroupNorm(8, w0, FLAX_EPS)
            self.conv_out = ConvNHWC(w0, out_channels, 3, padding=1)

    def forward(self, x, timestep, context=None, *, image_only: bool = False):
        """x (B, T, H, W, C), timestep (B,), context (B, L, D) or None."""
        b, t, h, w, c = x.shape
        x = x.reshape(b * t, h, w, c)
        temb = self.temb_out(F.silu(self.temb_in(positional_emb(timestep, self.widths[0]))))
        temb = temb.repeat_interleave(t, dim=0)
        ctx = context.repeat_interleave(t, dim=0) if context is not None else None
        kw = dict(num_frames=t, image_only=image_only)

        def attention(name, hid):
            hid = getattr(self, f"{name}_attn")(hid, **kw)
            if ctx is not None:
                hid = attend(getattr(self, f"{name}_cross"), hid, ctx)
            return hid

        n = len(self.widths)
        x = self.conv_in(x)
        skips = [x]
        for i in range(n):
            x = getattr(self, f"down_{i}_res")(x, temb, **kw)
            if self.attention_levels[i]:
                x = attention(f"down_{i}", x)
            skips.append(x)
            if i < n - 1:
                x = max_pool2(x)
        x = self.mid_res1(x, temb, **kw)
        x = attention("mid", x)
        x = self.mid_res2(x, temb, **kw)
        for i in reversed(range(n)):
            if i < n - 1:
                x = upsample2(x)
            x = getattr(self, f"up_{i}_res")(torch.cat([x, skips.pop()], dim=-1), temb, **kw)
            if self.attention_levels[i]:
                x = attention(f"up_{i}", x)
        x = self.conv_out(F.silu(self.norm_out(x)))
        return x.reshape(b, t, h, w, self.out_channels)
