"""Stable Video Diffusion's models: the spatio-temporal UNet and the VAE
with a temporal decoder (diffusers ``UNetSpatioTemporalConditionModel`` and
``AutoencoderKLTemporalDecoder``, as stabilityai/stable-video-diffusion-
img2vid-xt configures them).

Activations are channel-last with a clip's frames flattened into the
batch, ``(B*F, H, W, C)``, clips major and frames minor, as in
``unet_video``.  Every resnet is a ``ResnetBlock2D`` per frame blended with
a ``TemporalResnetBlock`` over the clip (GroupNorm statistics over the
whole clip, (3, 1, 1) convolutions over frames, ``ops.temporal_conv``);
every transformer a spatial block per frame blended with a temporal block
over each position's frames (K2, ``ops.attention.temporal_attention``); the
blends are ``AlphaBlender``'s learned sigmoid factors.  The cross-attention
context is one CLIP image token, so its softmax over one key is exactly 1
and the attention is the token's value, ``to_out(to_v(token))``, added to
every query (``ImageTokenAttention``): the same function with no scores.

Parameter names follow the port's convention (``down_blocks_0.resnets_0.
spatial_res_block.conv1.weight``, ``decoder.up_0_resnets_0...``), so one
seeded set loads into these modules and into the benchmark's reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from i2v_adapter_tpu_torch.config import SpatioTemporalUNetConfig, TemporalVAEConfig
from i2v_adapter_tpu_torch.device import DeviceLike, resolve_device
from i2v_adapter_tpu_torch.models.attention import Attention, FeedForward
from i2v_adapter_tpu_torch.models.layers import (ConvNHWC, Downsample2D, GroupNorm, LayerNorm, Linear,
                                                 ResnetBlock2D, TimestepEmbedding, Upsample2D, timestep_embedding)
from i2v_adapter_tpu_torch.models.temporal import TemporalSelfAttention
from i2v_adapter_tpu_torch.models.vae import Encoder, VAEAttention
from i2v_adapter_tpu_torch.ops.temporal_conv import temporal_conv3


class TemporalConv(nn.Conv3d):
    """``nn.Conv3d`` with kernel (3, 1, 1) and padding (1, 0, 0), applied to
    ``(B, F, S, C)`` clips through ``ops.temporal_conv.temporal_conv3``."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x):
        return temporal_conv3(x, self.weight, self.bias)


class AlphaBlender(nn.Module):
    """``alpha * spatial + (1 - alpha) * temporal`` with ``alpha =
    sigmoid(mix_factor)`` (diffusers' ``learned`` strategy; the UNet's
    ``learned_with_images`` is the same with no image-only frames);
    ``switch`` swaps the two (the temporal decoder's)."""

    def __init__(self, switch: bool = False):
        super().__init__()
        self.switch = switch
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def forward(self, spatial, temporal):
        alpha = torch.sigmoid(self.mix_factor.float())
        if self.switch:
            alpha = 1.0 - alpha
        return torch.lerp(temporal, spatial, alpha.to(spatial.dtype))


class TemporalResnetBlock(nn.Module):
    """GroupNorm over each clip -> SiLU -> (3,1,1) conv (+ the frame's
    time embedding) -> GroupNorm -> SiLU -> (3,1,1) conv, residual."""

    def __init__(self, channels: int, temb_channels, eps: float, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(groups, channels, eps)
        self.conv1 = TemporalConv(channels, channels)
        if temb_channels is not None:
            self.time_emb_proj = Linear(temb_channels, channels)
        self.norm2 = GroupNorm(groups, channels, eps)
        self.conv2 = TemporalConv(channels, channels)

    def forward(self, x, frames: int, temb=None):
        bf, h, w, c = x.shape
        clip = (bf // frames, frames * h * w, c)
        frame = (bf // frames, frames, h * w, c)
        y = self.conv1(self.norm1(x.reshape(clip), silu=True).view(frame))
        if temb is not None:
            y = y + self.time_emb_proj(F.silu(temb)).view(frame[0], frames, 1, c)
        y = self.conv2(self.norm2(y.view(clip), silu=True).view(frame))
        return x + y.view(bf, h, w, c)


class SpatioTemporalResBlock(nn.Module):
    """A ``ResnetBlock2D`` per frame, then a ``TemporalResnetBlock`` on its
    output, blended."""

    def __init__(self, cin: int, cout: int, temb_channels, eps: float, temporal_eps=None, groups: int = 32,
                 switch: bool = False):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb_channels, groups, eps)
        self.temporal_res_block = TemporalResnetBlock(cout, temb_channels,
                                                      eps if temporal_eps is None else temporal_eps, groups)
        self.time_mixer = AlphaBlender(switch)

    def forward(self, x, frames: int, temb=None):
        h = self.spatial_res_block(x, temb)
        return self.time_mixer(h, self.temporal_res_block(h, frames, temb))


class ImageTokenAttention(Attention):
    """Cross-attention to a context of one token per row: the softmax over
    one key is 1, so the output is ``to_out(to_v(token))`` for every query
    (``value``; ``to_q`` and ``to_k`` hold weights the result does not
    depend on)."""

    def value(self, context):
        if context.shape[1] != 1:
            raise ValueError(f"ImageTokenAttention takes one context token, got {context.shape[1]}")
        return self.to_out(self.to_v(context))


class SpatialBlock(nn.Module):
    """diffusers' ``BasicTransformerBlock``: self-attention (K1 at long
    sequences), cross-attention to the image token, GEGLU with exact GELU."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        kw = dict(heads=heads, dim_head=dim // heads)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, **kw)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = ImageTokenAttention(dim, context_dim=context_dim, **kw)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        """``x (N, S, C)``, ``context (N, 1, D)``; ``norm2`` feeds only the
        queries of the one-key attention and is not needed."""
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2.value(context)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module):
    """On ``(B, F, S, C)``: a feed-forward, self-attention over the frames
    (K2), cross-attention to the clip's first-frame image token, a
    feed-forward, each residual."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm_in = LayerNorm(dim, eps=1e-5)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = TemporalSelfAttention(dim, heads, dim // heads)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = ImageTokenAttention(dim, heads=heads, dim_head=dim // heads, context_dim=context_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        """``context (B, 1, D)``: each clip's first-frame token."""
        x = x + self.ff_in(self.norm_in(x))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2.value(context)[:, None]
        return x + self.ff(self.norm3(x))


class FramePositionEmbedding(nn.Module):
    """``TimestepEmbedding(C -> 4C -> C)`` of the frame index's sinusoid."""

    def __init__(self, channels: int):
        super().__init__()
        self.linear_1 = Linear(channels, 4 * channels)
        self.linear_2 = Linear(4 * channels, channels)

    def forward(self, frames: int, dtype, device):
        emb = timestep_embedding(torch.arange(frames, device=device), self.linear_1.in_features).to(dtype)
        return self.linear_2(F.silu(self.linear_1(emb)))


class TransformerSpatioTemporalModel(nn.Module):
    """GroupNorm per frame -> ``proj_in`` -> per layer: the spatial block,
    then the temporal block on its output plus the frame positions,
    blended -> ``proj_out`` + the input."""

    def __init__(self, channels: int, heads: int, context_dim: int, num_layers: int = 1, groups: int = 32):
        super().__init__()
        self.num_layers = num_layers
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = Linear(channels, channels)
        for i in range(num_layers):
            self.add_module(f"transformer_blocks_{i}", SpatialBlock(channels, heads, context_dim))
            self.add_module(f"temporal_transformer_blocks_{i}",
                            TemporalBasicTransformerBlock(channels, heads, context_dim))
        self.time_pos_embed = FramePositionEmbedding(channels)
        self.time_mixer = AlphaBlender()
        self.proj_out = Linear(channels, channels)

    def forward(self, x, context, frames: int):
        """``x (B*F, H, W, C)``, ``context (B*F, 1, D)``."""
        bf, h, w, c = x.shape
        b = bf // frames
        y = self.proj_in(self.norm(x)).view(bf, h * w, c)
        pos = self.time_pos_embed(frames, y.dtype, y.device)[None, :, None, :]
        first = context.view(b, frames, 1, -1)[:, 0]
        for i in range(self.num_layers):
            y = getattr(self, f"transformer_blocks_{i}")(y, context)
            m = getattr(self, f"temporal_transformer_blocks_{i}")(y.view(b, frames, h * w, c) + pos, first)
            y = self.time_mixer(y, m.view(bf, h * w, c))
        return self.proj_out(y).view(bf, h, w, c) + x


class _Block(nn.Module):
    """A down, mid or up block: ``resnets_<i>`` (each with
    ``attentions_<i>`` after it where the block attends), then the
    resampling conv."""

    def forward(self, x, emb, context, frames: int, skips=None):
        out = []
        for i in range(self.layers):
            if skips is not None:
                x = torch.cat([x, skips.pop()], dim=-1)
            x = getattr(self, f"resnets_{i}")(x, frames, emb)
            if hasattr(self, f"attentions_{i}"):
                x = getattr(self, f"attentions_{i}")(x, context, frames)
            out.append(x)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x)
            out.append(x)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x)
        return x, out


class SpatioTemporalUNet(nn.Module):
    """``forward(sample (B, F, H, W, in), timesteps (B,) or 0-d,
    image_embeds (B, 1, D), added_time_ids (B, 3)) -> (B, F, H, W, out)``,
    computing in the sample's dtype."""

    def __init__(self, config: SpatioTemporalUNetConfig, device: DeviceLike = None):
        super().__init__()
        self.config = cfg = config
        ch, n, layers, g = cfg.block_out_channels, len(cfg.block_out_channels), cfg.layers_per_block, cfg.norm_num_groups
        temb = cfg.time_embed_dim

        def attn(c, heads):
            return TransformerSpatioTemporalModel(c, heads, cfg.cross_attention_dim, cfg.transformer_layers_per_block, g)

        with torch.device(resolve_device(device)):
            self.conv_in = ConvNHWC(cfg.in_channels, ch[0], 3, padding=1)
            self.time_embedding = TimestepEmbedding(ch[0], temb)
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb)
            skip_ch, cin = [ch[0]], ch[0]
            for i in range(n):
                block = _Block()
                block.layers = layers
                for j in range(layers):
                    block.add_module(f"resnets_{j}", SpatioTemporalResBlock(cin, ch[i], temb, cfg.resnet_eps[i],
                                                                            groups=g))
                    cin = ch[i]
                    if cfg.down_block_has_attention[i]:
                        block.add_module(f"attentions_{j}", attn(ch[i], cfg.num_attention_heads[i]))
                skip_ch += [ch[i]] * layers
                if i < n - 1:
                    block.downsamplers_0 = Downsample2D(ch[i], ch[i])
                    skip_ch.append(ch[i])
                self.add_module(f"down_blocks_{i}", block)
            self.mid_block = nn.Module()
            self.mid_block.resnets_0 = SpatioTemporalResBlock(ch[-1], ch[-1], temb, cfg.mid_eps, groups=g)
            self.mid_block.attentions_0 = attn(ch[-1], cfg.num_attention_heads[-1])
            self.mid_block.resnets_1 = SpatioTemporalResBlock(ch[-1], ch[-1], temb, cfg.mid_eps, groups=g)
            x_ch = ch[-1]
            heads = tuple(reversed(cfg.num_attention_heads))
            for i, out in enumerate(reversed(ch)):
                block = _Block()
                block.layers = layers + 1
                for j in range(layers + 1):
                    block.add_module(f"resnets_{j}", SpatioTemporalResBlock(x_ch + skip_ch.pop(), out, temb,
                                                                            cfg.up_eps, groups=g))
                    x_ch = out
                    if cfg.up_block_has_attention[i]:
                        block.add_module(f"attentions_{j}", attn(out, heads[i]))
                if i < n - 1:
                    block.upsamplers_0 = Upsample2D(out, out)
                self.add_module(f"up_blocks_{i}", block)
            self.conv_norm_out = GroupNorm(g, ch[0], 1e-5)
            self.conv_out = ConvNHWC(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, image_embeds, added_time_ids):
        cfg = self.config
        b, f, h, w, c = sample.shape
        dtype = sample.dtype
        t = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(b)
        emb = self.time_embedding(timestep_embedding(t, cfg.block_out_channels[0]).to(dtype))
        ids = timestep_embedding(added_time_ids.reshape(-1), cfg.addition_time_embed_dim).reshape(b, -1)
        emb = (emb + self.add_embedding(ids.to(dtype))).repeat_interleave(f, dim=0)
        context = image_embeds.to(dtype).repeat_interleave(f, dim=0)
        x = self.conv_in(sample.reshape(b * f, h, w, c))
        skips = [x]
        n = len(cfg.block_out_channels)
        for i in range(n):
            x, out = getattr(self, f"down_blocks_{i}")(x, emb, context, f)
            skips += out
        mid = self.mid_block
        x = mid.resnets_1(mid.attentions_0(mid.resnets_0(x, f, emb), context, f), f, emb)
        for i in range(n):
            x, _ = getattr(self, f"up_blocks_{i}")(x, emb, context, f, skips=skips)
        x = self.conv_out(self.conv_norm_out(x, silu=True))
        return x.reshape(b, f, h, w, cfg.out_channels)


def _decoder_resnet(cin: int, cout: int, groups: int) -> SpatioTemporalResBlock:
    return SpatioTemporalResBlock(cin, cout, None, 1e-6, 1e-5, groups, switch=True)


class TemporalDecoder(nn.Module):
    """``forward(z (N, h, w, latent), frames) -> (N, H, W, out)``: the N
    latents are N // frames clips of ``frames`` frames each."""

    def __init__(self, cfg: TemporalVAEConfig):
        super().__init__()
        self.cfg = cfg
        rev, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = ConvNHWC(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_resnets_0 = _decoder_resnet(rev[0], rev[0], g)
        self.mid_attn = VAEAttention(rev[0], g)
        self.mid_resnets_1 = _decoder_resnet(rev[0], rev[0], g)
        cin = rev[0]
        for i, c in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_resnets_{j}", _decoder_resnet(cin, c, g))
                cin = c
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", Upsample2D(c, c))
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = ConvNHWC(rev[-1], cfg.out_channels, 3, padding=1)
        self.time_conv_out = TemporalConv(cfg.out_channels, cfg.out_channels)

    def forward(self, z, frames: int):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        x = self.mid_resnets_0(self.conv_in(z), frames)
        x = self.mid_resnets_1(self.mid_attn(x), frames)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_{i}_resnets_{j}")(x, frames)
            if i < n - 1:
                x = getattr(self, f"up_{i}_upsample")(x)
        x = self.conv_out(self.conv_norm_out(x, silu=True))
        bf, h, w, c = x.shape
        return self.time_conv_out(x.view(bf // frames, frames, h * w, c)).view(bf, h, w, c)


class AutoencoderKLTemporalDecoder(nn.Module):
    """The SD VAE encoder and ``quant_conv``, and ``TemporalDecoder``;
    channel-last."""

    def __init__(self, config: TemporalVAEConfig, device: DeviceLike = None):
        super().__init__()
        self.config = config
        lc = config.latent_channels
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(config.encoder_config())
            self.quant_conv = ConvNHWC(2 * lc, 2 * lc, 1)
            self.decoder = TemporalDecoder(config)

    def encode_mean(self, x) -> torch.Tensor:
        """The posterior's mean (its mode) of ``x (N, H, W, 3)`` in [-1, 1],
        not multiplied by ``scaling_factor``."""
        return self.quant_conv(self.encoder(x)).chunk(2, dim=-1)[0]

    def decode(self, z, num_frames: int) -> torch.Tensor:
        """``z (N, h, w, latent)``, N // num_frames clips -> frames."""
        if z.shape[0] % num_frames:
            raise ValueError(f"{z.shape[0]} latents are not clips of {num_frames} frames")
        return self.decoder(z, num_frames)
