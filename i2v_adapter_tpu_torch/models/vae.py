"""SD AutoencoderKL, channel-last (N, H, W, C) like the JAX package."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from i2v_adapter_tpu_torch.config import VAEConfig
from i2v_adapter_tpu_torch.device import DeviceLike, resolve_device
from i2v_adapter_tpu_torch.models.layers import (
    ConvNHWC,
    Downsample2D,
    GroupNorm,
    Linear,
    ResnetBlock2D,
    Upsample2D,
)


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial tokens (mid block): plain
    matmuls and an fp32 softmax with scale 1/sqrt(C)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = Linear(channels, channels)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        scores = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
        probs = torch.softmax(scores / math.sqrt(c), dim=-1)
        y = torch.einsum("bqk,bkc->bqc", probs.to(v.dtype).float(), v.float()).to(x.dtype)
        return x + self.to_out(y).reshape(b, h, w, c)


def _resnet(cin, cout, cfg):
    return ResnetBlock2D(cin, cout, None, cfg.norm_num_groups, 1e-6)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        chans = cfg.block_out_channels
        self.conv_in = ConvNHWC(cfg.in_channels, chans[0], 3, padding=1)
        cin = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_resnets_{j}", _resnet(cin, ch, cfg))
                cin = ch
            if i < len(chans) - 1:
                self.add_module(f"down_{i}_downsample", Downsample2D(ch, ch, asymmetric_pad=True))
        self.mid_resnets_0 = _resnet(chans[-1], chans[-1], cfg)
        self.mid_attn = VAEAttention(chans[-1], cfg.norm_num_groups)
        self.mid_resnets_1 = _resnet(chans[-1], chans[-1], cfg)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, chans[-1], 1e-6)
        self.conv_out = ConvNHWC(chans[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        x = self.conv_in(x)
        for i in range(n):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_resnets_{j}")(x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
        x = self.mid_resnets_1(self.mid_attn(self.mid_resnets_0(x)))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = ConvNHWC(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_resnets_0 = _resnet(rev[0], rev[0], cfg)
        self.mid_attn = VAEAttention(rev[0], cfg.norm_num_groups)
        self.mid_resnets_1 = _resnet(rev[0], rev[0], cfg)
        cin = rev[0]
        for i, ch in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_resnets_{j}", _resnet(cin, ch, cfg))
                cin = ch
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", Upsample2D(ch, ch))
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, rev[-1], 1e-6)
        self.conv_out = ConvNHWC(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        x = self.mid_resnets_1(self.mid_attn(self.mid_resnets_0(self.conv_in(z))))
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_{i}_resnets_{j}")(x)
            if i < n - 1:
                x = getattr(self, f"up_{i}_upsample")(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """encode -> (mean, logvar) moments; decode(z) -> image.  Channel-last."""

    def __init__(self, config: VAEConfig, device: DeviceLike = None):
        super().__init__()
        if config.int8_decode:
            raise NotImplementedError("not ported yet: int8_decode (ROADMAP: int8 serving convs)")
        self.config = config
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(config)
            self.decoder = Decoder(config)
            self.quant_conv = ConvNHWC(2 * config.latent_channels, 2 * config.latent_channels, 1)
            self.post_quant_conv = ConvNHWC(config.latent_channels, config.latent_channels, 1)

    def encode_moments(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = self.quant_conv(self.encoder(x))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               slice_size: int = 0) -> torch.Tensor:
        """Posterior sample ``mean + std * noise`` with the given noise, or
        noise drawn from ``generator``; the mean when neither is given.  Not
        yet multiplied by ``scaling_factor``.

        ``slice_size`` > 0 dividing the batch encodes that many images at a
        time (the training step's ``vae_encode_slice``), which bounds the
        encoder's peak activation memory; slice i takes rows
        ``[i*slice_size, (i+1)*slice_size)`` of ``noise``."""
        n = x.shape[0]
        if noise is None and generator is not None:
            noise = torch.randn(self.latent_shape(x.shape), generator=generator,
                                device=x.device, dtype=torch.float32)
        if slice_size > 0 and n % slice_size == 0 and n > slice_size:
            return torch.cat([
                self.encode(x[i:i + slice_size],
                            None if noise is None else noise[i:i + slice_size])
                for i in range(0, n, slice_size)
            ])
        mean, logvar = self.encode_moments(x)
        if noise is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def latent_shape(self, x_shape) -> Tuple[int, ...]:
        """Shape of ``encode``'s output for an input of shape ``x_shape``."""
        n, h, w, _ = x_shape
        s = self.config.spatial_scale_factor
        return (n, h // s, w // s, self.config.latent_channels)

    def decode(self, z) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x, noise=None):
        return self.decode(self.encode(x, noise))
