"""SD AutoencoderKL, channel-last (N, H, W, C) like the JAX package."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from i2v_adapter_tpu_torch.config import VAEConfig
from i2v_adapter_tpu_torch.device import DeviceLike, resolve_device
from i2v_adapter_tpu_torch.models.layers import (
    ConvNHWC,
    Downsample2D,
    GroupNorm,
    Linear,
    ResnetBlock2D,
    Upsample2D,
    set_int8,
)
from i2v_adapter_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, gather, shard
from i2v_adapter_tpu_torch.parallel.spmd import attention_spmd


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


def _resnet(cin, cout, cfg, int8: bool = False):
    return ResnetBlock2D(cin, cout, None, cfg.norm_num_groups, 1e-6, int8=int8)


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
        return self.conv_out(self.conv_norm_out(x, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        rev = tuple(reversed(cfg.block_out_channels))
        int8 = cfg.int8_decode
        self.conv_in = ConvNHWC(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_resnets_0 = _resnet(rev[0], rev[0], cfg, int8)
        self.mid_attn = VAEAttention(rev[0], cfg.norm_num_groups)
        self.mid_resnets_1 = _resnet(rev[0], rev[0], cfg, int8)
        cin = rev[0]
        for i, ch in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_resnets_{j}", _resnet(cin, ch, cfg, int8))
                cin = ch
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", Upsample2D(ch, ch, int8=int8))
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
        return self.conv_out(self.conv_norm_out(x, silu=True))


class AutoencoderKL(nn.Module):
    """encode -> (mean, logvar) moments; decode(z) -> image.  Channel-last.
    ``config.int8_decode`` (serving) runs the decoder's mid and up resnets'
    3x3 convs and its upsample convs in int8; the encoder stays exact."""

    def __init__(self, config: VAEConfig, device: DeviceLike = None):
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(config)
            self.decoder = Decoder(config)
            self.quant_conv = ConvNHWC(2 * config.latent_channels, 2 * config.latent_channels, 1)
            self.post_quant_conv = ConvNHWC(config.latent_channels, config.latent_channels, 1)

    def set_int8(self, enabled: bool) -> None:
        """Switch the decoder's int8 convs (``config.int8_decode``) on or
        off; the parameters are unchanged."""
        self.config = self.config.replace(int8_decode=enabled)
        set_int8(self.decoder, enabled)

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


def decode_sliced(decode, z: torch.Tensor, slice_size: int = 1) -> torch.Tensor:
    """Decode (N, h, w, c) latents ``slice_size`` frames at a time with
    ``decode`` (the JAX ``decode_sliced``, a ``lax.map`` there): peak memory
    bounded by the slice.  Each slice is one decoder call, so the int8
    decoder's per-tensor activation scales are per slice."""
    n = z.shape[0]
    if n % slice_size != 0:
        raise ValueError(f"{n} frames not divisible by slice {slice_size}")
    return torch.cat([decode(z[i:i + slice_size]) for i in range(0, n, slice_size)])


def decode_sharded(decode, z: torch.Tensor, mesh) -> torch.Tensor:
    """Frame-parallel decode over a serving mesh (the JAX ``decode_sharded``,
    which the JAX sampler applies as its ``shard_flat`` layout): the frames
    of ``z (N, h, w, c)`` split over ``data`` x ``seq``, each rank decoding
    its block, the decoded frames gathered on every rank.  The int8
    decoder's activation scales are the MAX over the blocks, the whole
    batch's, as one decoder call on one card takes them.  Frames that do
    not split decode whole on every rank."""
    axes = (DATA_AXIS, SEQ_AXIS)
    if mesh.size(axes) == 1 or z.shape[0] % mesh.size(axes):
        return decode(z)
    with attention_spmd(mesh, clip_split=True, frame_split=True):
        video = decode(shard(z, 0, mesh, axes))
    return gather(video, 0, mesh, axes)


def decode_tiled(decode, z: torch.Tensor, tile_latent_size: int = 64,
                 overlap: float = 0.25) -> torch.Tensor:
    """Spatially tiled decode with linear blending over the overlaps (the
    JAX ``decode_tiled``, for 768 px and larger frames).  Latents no larger
    than one tile decode whole; each tile is one decoder call (per-tile
    int8 activation scales)."""
    _, h, w, _ = z.shape
    stride = int(tile_latent_size * (1 - overlap))
    if h <= tile_latent_size and w <= tile_latent_size:
        return decode(z)
    edge = int(tile_latent_size * overlap)
    rows = [[decode(z[:, i:i + tile_latent_size, j:j + tile_latent_size])
             for j in range(0, max(w - edge, 1), stride)]
            for i in range(0, max(h - edge, 1), stride)]
    scale = rows[0][0].shape[1] // min(tile_latent_size, h)
    blend = edge * scale

    def mix(a, b, dim):
        if blend == 0:
            return torch.cat([a, b], dim=dim)
        shape = [1, 1, 1, 1]
        shape[dim] = blend
        alpha = torch.from_numpy(np.linspace(0, 1, blend, dtype=np.float32)).reshape(shape)
        alpha = alpha.to(a.device, a.dtype)
        mixed = a.narrow(dim, a.shape[dim] - blend, blend) * (1 - alpha) + b.narrow(dim, 0, blend) * alpha
        return torch.cat([a.narrow(dim, 0, a.shape[dim] - blend), mixed,
                          b.narrow(dim, blend, b.shape[dim] - blend)], dim=dim)

    row_images = []
    for row in rows:
        acc = row[0]
        for tile in row[1:]:
            acc = mix(acc, tile, 2)
        row_images.append(acc)
    image = row_images[0]
    for r in row_images[1:]:
        image = mix(image, r, 1)
    return image
