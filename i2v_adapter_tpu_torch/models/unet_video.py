"""The motion + cross-frame-attention video UNet.

Counterpart of the JAX ``models/unet_video.py``: SD1.5 spatial blocks
hosting the I2V-Adapter cross-frame attention, the IP-Adapter image branch
(standard head) and AnimateDiff motion modules.  Activations are
channel-last with frames flattened into the batch, ``(B*F, H, W, C)``,
clips major and frames minor; the public input is ``(B, F, H, W, C)``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from i2v_adapter_tpu_torch.config import VideoUNetConfig
from i2v_adapter_tpu_torch.device import DeviceLike, resolve_device
from i2v_adapter_tpu_torch.models.attention import Attention, SpatialTransformer
from i2v_adapter_tpu_torch.models.layers import (
    ConvNHWC,
    Downsample2D,
    GroupNorm,
    LayerNorm,
    Linear,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    timestep_embedding,
)
from i2v_adapter_tpu_torch.models.temporal import TemporalSelfAttention, TemporalTransformer


def _check_ported(cfg: VideoUNetConfig) -> None:
    """Refuse the configurations whose code paths are not ported yet."""
    missing = []
    if cfg.int8_conv:
        missing.append("int8_conv (ROADMAP: int8 serving convs)")
    if cfg.conv_impl == "pallas":
        missing.append("conv_impl='pallas' (ROADMAP: K4 fused GN+SiLU+conv)")
    if cfg.ip_variant != "standard":
        missing.append(f"ip_variant={cfg.ip_variant!r} (ROADMAP: plus/full_face IP heads)")
    if cfg.freeu is not None:
        missing.append("freeu (ROADMAP: FreeU)")
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))


class ImageProjection(nn.Module):
    """IP-Adapter standard head: image_embeds (B, D_img) -> (B, N, C_text)."""

    def __init__(self, image_embed_dim: int, num_tokens: int, cross_attention_dim: int):
        super().__init__()
        self.num_tokens, self.cross_attention_dim = num_tokens, cross_attention_dim
        self.proj = Linear(image_embed_dim, num_tokens * cross_attention_dim)
        self.norm = LayerNorm(cross_attention_dim, eps=1e-6)

    def forward(self, image_embeds):
        x = self.proj(image_embeds)
        return self.norm(x.reshape(x.shape[0], self.num_tokens, self.cross_attention_dim))


def _spatial(cfg: VideoUNetConfig, ch: int, attn_impl: str) -> SpatialTransformer:
    return SpatialTransformer(
        ch, heads=cfg.num_attention_heads, dim_head=ch // cfg.num_attention_heads,
        context_dim=cfg.cross_attention_dim, num_layers=cfg.transformer_layers_per_block,
        use_linear_projection=cfg.use_linear_projection, use_i2v_adapter=cfg.use_i2v_adapter,
        ip_num_tokens=cfg.ip_num_tokens if cfg.use_ip_adapter else 0, ip_scale=cfg.ip_scale,
        groups=cfg.norm_num_groups, attn_impl=attn_impl, static_max=cfg.flash_static_max,
        gelu_tanh=cfg.fast_gelu,
    )


def _motion(cfg: VideoUNetConfig, ch: int, attn_impl: str) -> TemporalTransformer:
    return TemporalTransformer(
        ch, heads=cfg.motion_num_attention_heads, dim_head=ch // cfg.motion_num_attention_heads,
        max_seq_length=cfg.motion_max_seq_length, groups=cfg.norm_num_groups,
        attn_impl=attn_impl, gelu_tanh=cfg.fast_gelu,
    )


class DownBlock(nn.Module):
    """[resnet (+ spatial transformer) + motion] x L, optional downsample."""

    def __init__(self, cfg: VideoUNetConfig, in_channels: int, out_channels: int,
                 num_layers: int, has_attention: bool, add_downsample: bool, attn_impl: str):
        super().__init__()
        self.num_layers, self.has_attention = num_layers, has_attention
        self.use_motion = cfg.use_motion_modules
        self.add_downsample = add_downsample
        for i in range(num_layers):
            self.add_module(f"resnets_{i}", ResnetBlock2D(
                in_channels if i == 0 else out_channels, out_channels, cfg.time_embed_dim,
                cfg.norm_num_groups, cfg.norm_eps,
            ))
            if has_attention:
                self.add_module(f"attentions_{i}", _spatial(cfg, out_channels, attn_impl))
            if self.use_motion:
                self.add_module(f"motion_modules_{i}", _motion(cfg, out_channels, attn_impl))
        if add_downsample:
            self.downsamplers_0 = Downsample2D(out_channels, out_channels)

    def forward(self, x, temb, ctx, cross_frame: bool, num_frames: int):
        skips = []
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            if self.has_attention:
                x = getattr(self, f"attentions_{i}")(
                    x, ctx, enable_cross_frame_attn=cross_frame, num_frames=num_frames
                )
            if self.use_motion:
                x = getattr(self, f"motion_modules_{i}")(x, num_frames=num_frames)
            skips.append(x)
        if self.add_downsample:
            x = self.downsamplers_0(x)
            skips.append(x)
        return x, skips


class UpBlock(nn.Module):
    """Skip-concat resnets (+ spatial transformer) + motion, optional upsample."""

    def __init__(self, cfg: VideoUNetConfig, resnet_in: List[int], out_channels: int,
                 has_attention: bool, add_upsample: bool, attn_impl: str):
        super().__init__()
        self.num_layers, self.has_attention = len(resnet_in), has_attention
        self.use_motion = cfg.use_motion_modules
        self.add_upsample = add_upsample
        for i, cin in enumerate(resnet_in):
            self.add_module(f"resnets_{i}", ResnetBlock2D(
                cin, out_channels, cfg.time_embed_dim, cfg.norm_num_groups, cfg.norm_eps,
            ))
            if has_attention:
                self.add_module(f"attentions_{i}", _spatial(cfg, out_channels, attn_impl))
            if self.use_motion:
                self.add_module(f"motion_modules_{i}", _motion(cfg, out_channels, attn_impl))
        if add_upsample:
            self.upsamplers_0 = Upsample2D(out_channels, out_channels)

    def forward(self, x, skips, temb, ctx, cross_frame: bool, num_frames: int):
        for i in range(self.num_layers):
            x = torch.cat([x, skips[-(i + 1)]], dim=-1)
            x = getattr(self, f"resnets_{i}")(x, temb)
            if self.has_attention:
                x = getattr(self, f"attentions_{i}")(
                    x, ctx, enable_cross_frame_attn=cross_frame, num_frames=num_frames
                )
            if self.use_motion:
                x = getattr(self, f"motion_modules_{i}")(x, num_frames=num_frames)
        if self.add_upsample:
            x = self.upsamplers_0(x)
        return x


class MidBlock(nn.Module):
    """resnet -> [spatial attn -> motion -> resnet]."""

    def __init__(self, cfg: VideoUNetConfig, channels: int, attn_impl: str):
        super().__init__()
        self.use_motion = cfg.use_motion_modules and cfg.use_motion_mid_block
        self.resnets_0 = ResnetBlock2D(channels, channels, cfg.time_embed_dim,
                                       cfg.norm_num_groups, cfg.norm_eps)
        self.attentions_0 = _spatial(cfg, channels, attn_impl)
        if self.use_motion:
            self.motion_modules_0 = _motion(cfg, channels, attn_impl)
        self.resnets_1 = ResnetBlock2D(channels, channels, cfg.time_embed_dim,
                                       cfg.norm_num_groups, cfg.norm_eps)

    def forward(self, x, temb, ctx, cross_frame: bool, num_frames: int):
        x = self.resnets_0(x, temb)
        x = self.attentions_0(x, ctx, enable_cross_frame_attn=cross_frame, num_frames=num_frames)
        if self.use_motion:
            x = self.motion_modules_0(x, num_frames=num_frames)
        return self.resnets_1(x, temb)


class VideoUNet(nn.Module):
    """Full video UNet.

    forward(sample (B, F, H, W, C_in), timestep scalar or (B,),
    encoder_hidden_states (B, L, C_text), image_embeds (B, D_img)) ->
    (B, F, H, W, C_out).  Parameters are created in fp32 on ``device`` (the
    GPU unless ``device="cpu"``); callers cast with ``.to``.  The compute
    dtype is ``dtype`` when given, else the storage dtype of ``conv_in``.
    With ``config.remat`` each Down/Mid/Up block runs under activation
    checkpointing while gradients are recorded (the blocks the JAX package
    wraps in ``nn.remat``)."""

    def __init__(self, config: VideoUNetConfig, device: DeviceLike = None):
        super().__init__()
        _check_ported(config)
        cfg = self.config = config
        attn_impl = "auto" if cfg.flash_attention else "plain"
        chans = cfg.block_out_channels
        n = cfg.num_blocks
        with torch.device(resolve_device(device)):
            self.time_embedding = TimestepEmbedding(chans[0], cfg.time_embed_dim)
            if cfg.use_ip_adapter:
                self.encoder_hid_proj = ImageProjection(
                    cfg.image_embed_dim, cfg.ip_num_tokens, cfg.cross_attention_dim
                )
            self.conv_in = ConvNHWC(cfg.in_channels, chans[0], 3, padding=1)
            skip_ch = [chans[0]]
            cin = chans[0]
            for i in range(n):
                self.add_module(f"down_blocks_{i}", DownBlock(
                    cfg, cin, chans[i], cfg.layers_per_block, cfg.down_block_has_attention[i],
                    i < n - 1, attn_impl,
                ))
                skip_ch += [chans[i]] * (cfg.layers_per_block + (1 if i < n - 1 else 0))
                cin = chans[i]
            self.mid_block = MidBlock(cfg, chans[-1], attn_impl)
            x_ch = chans[-1]
            for i, out in enumerate(reversed(chans)):
                num_layers = cfg.layers_per_block + 1
                block_skips, skip_ch = skip_ch[-num_layers:], skip_ch[:-num_layers]
                resnet_in = []
                for j in range(num_layers):
                    resnet_in.append((x_ch if j == 0 else out) + block_skips[-(j + 1)])
                self.add_module(f"up_blocks_{i}", UpBlock(
                    cfg, resnet_in, out, cfg.up_block_has_attention[i], i < n - 1, attn_impl,
                ))
                x_ch = out
            self.conv_norm_out = GroupNorm(cfg.norm_num_groups, chans[0], cfg.norm_eps)
            self.conv_out = ConvNHWC(chans[0], cfg.out_channels, 3, padding=1)

    def set_attn_impl(self, impl: str) -> None:
        """Route every attention site through ``impl`` ("auto", "kernel" or
        "plain"); the config's ``flash_attention`` sets it at construction."""
        for m in self.modules():
            if isinstance(m, (Attention, TemporalSelfAttention)):
                m.attn_impl = impl

    def _block(self, block: nn.Module, *args, **kwargs):
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False, **kwargs)
        return block(*args, **kwargs)

    def forward(self, sample, timestep, encoder_hidden_states, image_embeds=None, *,
                enable_cross_frame_attn: bool = False, dtype: Optional[torch.dtype] = None):
        cfg = self.config
        b, f, h, w, c = sample.shape
        dtype = dtype or self.conv_in.weight.dtype
        dev = sample.device
        ts = torch.as_tensor(timestep, dtype=torch.float32, device=dev).reshape(-1).expand(b)
        emb = self.time_embedding(timestep_embedding(ts, cfg.block_out_channels[0]).to(dtype))
        emb = emb.repeat_interleave(f, dim=0)

        encoder_hidden_states = encoder_hidden_states.to(dtype)
        if cfg.use_ip_adapter:
            if image_embeds is None:
                raise ValueError("image_embeds required when use_ip_adapter")
            image_tokens = self.encoder_hid_proj(image_embeds.to(dtype))
            encoder_hidden_states = torch.cat([encoder_hidden_states, image_tokens], dim=1)
        ctx = encoder_hidden_states.repeat_interleave(f, dim=0)

        x = self.conv_in(sample.reshape(b * f, h, w, c).to(dtype))
        block = dict(cross_frame=enable_cross_frame_attn, num_frames=f)
        skips = [x]
        for i in range(cfg.num_blocks):
            x, block_skips = self._block(getattr(self, f"down_blocks_{i}"), x, emb, ctx, **block)
            skips.extend(block_skips)
        x = self._block(self.mid_block, x, emb, ctx, **block)
        for i in range(cfg.num_blocks):
            num_layers = cfg.layers_per_block + 1
            block_skips, skips = skips[-num_layers:], skips[:-num_layers]
            x = self._block(getattr(self, f"up_blocks_{i}"), x, block_skips, emb, ctx, **block)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, f, h, w, cfg.out_channels)
