"""The plain reference of one Stable Video Diffusion (img2vid-xt) request.

Plain PyTorch in float32 on channel-last activations, with no kernel, no
graph and no shortcut of its own: the spatio-temporal UNet (diffusers'
``UNetSpatioTemporalConditionModel``), the VAE encoder and the temporal
decoder (``AutoencoderKLTemporalDecoder``), the CLIP ViT-H/14 tower, and
the EDM Euler sampler with Karras sigmas and v-prediction, as the
published configurations describe them.  The cross-attentions to the one
image token run as full attention (softmax over one key); the (3, 1, 1)
convolutions are ``F.conv3d``.  It reuses the SD blocks of ``model.py``
(the resnets, attention, GEGLU, the VAE encoder, the CLIP tower) and, like
them, puts every matmul, convolution and attention operand through a
``Precision`` (``lower.Lowered`` for the control).  Parameter names are the
program's (``down_blocks_0.resnets_0.spatial_res_block.conv1.weight``), so
one seeded set of weights loads into both.  It imports nothing of the
program.

``clip`` runs one request from the same image, seed and weights as the
program, drawing the same random numbers from a device generator seeded
with the request's seed, in the program's order: the augmentation noise
(the image's shape), then the initial latents.  It returns the uint8 frames
and the final latents.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.model import (EXACT, GEGLU, Attn, Conv, Encoder, FrameAttn, GroupNorm, Lin, Precision,
                                       Resnet, VAEAttn, VisionEncoder, layer_norm, timestep_embedding)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class Conv3(nn.Module):
    """``nn.Conv3d`` with kernel (3, 1, 1), padding (1, 0, 0), on ``(B, F,
    S, C)``."""

    def __init__(self, cin: int, cout: int, prec: Precision):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 1, 1, device="meta"))
        self.bias = nn.Parameter(torch.empty(cout, device="meta"))

    def forward(self, x):
        x, w = self.prec.act(x, "fp"), self.prec.weight(self.weight, "fp")
        y = F.conv3d(x.permute(0, 3, 1, 2)[..., None], w, self.bias, padding=(1, 0, 0))
        return y[..., 0].permute(0, 2, 3, 1)


class Blend(nn.Module):
    def __init__(self, switch: bool = False):
        super().__init__()
        self.switch = switch
        self.mix_factor = nn.Parameter(torch.empty(1, device="meta"))

    def forward(self, spatial, temporal):
        a = torch.sigmoid(self.mix_factor)
        if self.switch:
            a = 1.0 - a
        return a * spatial + (1.0 - a) * temporal


class TemporalResnet(nn.Module):
    def __init__(self, c, temb, eps, groups, prec):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(groups, c, eps), Conv3(c, c, prec)
        if temb is not None:
            self.time_emb_proj = Lin(temb, c, prec=prec)
        self.norm2, self.conv2 = GroupNorm(groups, c, eps), Conv3(c, c, prec)

    def forward(self, x, frames, temb=None):
        bf, h, w, c = x.shape
        clip = (bf // frames, frames, h * w, c)
        y = self.conv1(F.silu(self.norm1(x.reshape(clip))))
        if temb is not None:
            y = y + self.time_emb_proj(F.silu(temb)).reshape(clip[0], frames, 1, c)
        y = self.conv2(F.silu(self.norm2(y)))
        return x + y.reshape(bf, h, w, c)


class STResnet(nn.Module):
    def __init__(self, cin, cout, temb, eps, groups, prec, temporal_eps=None, switch=False):
        super().__init__()
        self.spatial_res_block = Resnet(cin, cout, temb, groups, eps, prec, "fp")
        self.temporal_res_block = TemporalResnet(cout, temb, eps if temporal_eps is None else temporal_eps,
                                                 groups, prec)
        self.time_mixer = Blend(switch)

    def forward(self, x, frames, temb=None):
        h = self.spatial_res_block(x, temb)
        return self.time_mixer(h, self.temporal_res_block(h, frames, temb))


class SpatialBlock(nn.Module):
    def __init__(self, dim, heads, context, prec):
        super().__init__()
        self.norm1, self.attn1 = layer_norm(dim, 1e-5), Attn(dim, heads, prec=prec)
        self.norm2, self.attn2 = layer_norm(dim, 1e-5), Attn(dim, heads, context=context, prec=prec)
        self.norm3, self.ff = layer_norm(dim, 1e-5), GEGLU(dim, False, prec)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class TemporalBlock(nn.Module):
    """On ``(B, F, S, C)``: each position's frames attend to each other,
    then to the clip's first-frame image token."""

    def __init__(self, dim, heads, context, prec):
        super().__init__()
        self.norm_in, self.ff_in = layer_norm(dim, 1e-5), GEGLU(dim, False, prec)
        self.norm1, self.attn1 = layer_norm(dim, 1e-5), FrameAttn(dim, heads, prec)
        self.norm2, self.attn2 = layer_norm(dim, 1e-5), Attn(dim, heads, context=context, prec=prec)
        self.norm3, self.ff = layer_norm(dim, 1e-5), GEGLU(dim, False, prec)

    def forward(self, x, first):
        b, f, s, c = x.shape
        x = x + self.ff_in(self.norm_in(x))
        x = x + self.attn1(self.norm1(x))
        tokens = self.norm2(x).permute(0, 2, 1, 3).reshape(b * s, f, c)
        cross = self.attn2(tokens, first, kv_repeat=s)
        x = x + cross.reshape(b, s, f, c).permute(0, 2, 1, 3)
        return x + self.ff(self.norm3(x))


class STTransformer(nn.Module):
    def __init__(self, ch, heads, context, groups, layers, prec):
        super().__init__()
        self.layers = layers
        self.norm = GroupNorm(groups, ch, 1e-6)
        self.proj_in, self.proj_out = Lin(ch, ch, prec=prec), Lin(ch, ch, prec=prec)
        for i in range(layers):
            self.add_module(f"transformer_blocks_{i}", SpatialBlock(ch, heads, context, prec))
            self.add_module(f"temporal_transformer_blocks_{i}", TemporalBlock(ch, heads, context, prec))
        self.time_pos_embed = nn.Module()
        self.time_pos_embed.linear_1 = Lin(ch, 4 * ch, prec=prec)
        self.time_pos_embed.linear_2 = Lin(4 * ch, ch, prec=prec)
        self.time_mixer = Blend()

    def forward(self, x, ctx, frames):
        bf, h, w, c = x.shape
        b = bf // frames
        y = self.proj_in(self.norm(x)).reshape(bf, h * w, c)
        p = self.time_pos_embed
        pos = p.linear_2(F.silu(p.linear_1(timestep_embedding(torch.arange(frames, device=x.device), c))))
        first = ctx.reshape(b, frames, 1, -1)[:, 0]
        for i in range(self.layers):
            y = getattr(self, f"transformer_blocks_{i}")(y, ctx)
            m = getattr(self, f"temporal_transformer_blocks_{i}")(y.reshape(b, frames, h * w, c)
                                                                  + pos[None, :, None, :], first)
            y = self.time_mixer(y, m.reshape(bf, h * w, c))
        return self.proj_out(y).reshape(bf, h, w, c) + x


def _embedding(cin, cout, prec):
    m = nn.Module()
    m.linear_1, m.linear_2 = Lin(cin, cout, prec=prec), Lin(cout, cout, prec=prec)
    return m


class UNet(nn.Module):
    """``forward(sample (B, F, H, W, in), t (B,), embeds (B, 1, D), time_ids
    (B, 3)) -> (B, F, H, W, out)``; ``ucfg`` is the configuration file's
    ``unet`` group."""

    def __init__(self, ucfg: dict, prec: Precision = EXACT):
        super().__init__()
        self.cfg = ucfg
        ch, n, layers, g = ucfg["block_out_channels"], len(ucfg["block_out_channels"]), ucfg["layers_per_block"], \
            ucfg["norm_num_groups"]
        temb, heads, ctx = ch[0] * 4, ucfg["num_attention_heads"], ucfg["cross_attention_dim"]
        tl = ucfg["transformer_layers_per_block"]
        self.conv_in = Conv(ucfg["in_channels"], ch[0], 3, padding=1, prec=prec)
        self.time_embedding = _embedding(ch[0], temb, prec)
        self.add_embedding = _embedding(ucfg["projection_class_embeddings_input_dim"], temb, prec)
        skip, cin = [ch[0]], ch[0]
        for i in range(n):
            block = nn.Module()
            for j in range(layers):
                block.add_module(f"resnets_{j}", STResnet(cin, ch[i], temb, ucfg["resnet_eps"][i], g, prec))
                cin = ch[i]
                if ucfg["down_block_has_attention"][i]:
                    block.add_module(f"attentions_{j}", STTransformer(ch[i], heads[i], ctx, g, tl, prec))
                skip.append(ch[i])
            if i < n - 1:
                block.downsamplers_0 = nn.Module()
                block.downsamplers_0.conv = Conv(ch[i], ch[i], 3, stride=2, padding=1, prec=prec)
                skip.append(ch[i])
            self.add_module(f"down_blocks_{i}", block)
        self.mid_block = nn.Module()
        self.mid_block.resnets_0 = STResnet(ch[-1], ch[-1], temb, ucfg["mid_eps"], g, prec)
        self.mid_block.attentions_0 = STTransformer(ch[-1], heads[-1], ctx, g, tl, prec)
        self.mid_block.resnets_1 = STResnet(ch[-1], ch[-1], temb, ucfg["mid_eps"], g, prec)
        x_ch = ch[-1]
        for i, out in enumerate(reversed(ch)):
            block = nn.Module()
            for j in range(layers + 1):
                block.add_module(f"resnets_{j}", STResnet(x_ch + skip.pop(), out, temb, ucfg["up_eps"], g, prec))
                x_ch = out
                if ucfg["up_block_has_attention"][i]:
                    block.add_module(f"attentions_{j}", STTransformer(out, heads[n - 1 - i], ctx, g, tl, prec))
            if i < n - 1:
                block.upsamplers_0 = nn.Module()
                block.upsamplers_0.conv = Conv(out, out, 3, padding=1, prec=prec)
            self.add_module(f"up_blocks_{i}", block)
        self.conv_norm_out = GroupNorm(g, ch[0], 1e-5)
        self.conv_out = Conv(ch[0], ucfg["out_channels"], 3, padding=1, prec=prec)

    def _layer(self, block, j, x, emb, ctx, f):
        x = getattr(block, f"resnets_{j}")(x, f, emb)
        if hasattr(block, f"attentions_{j}"):
            x = getattr(block, f"attentions_{j}")(x, ctx, f)
        return x

    def forward(self, sample, t, embeds, time_ids):
        cfg = self.cfg
        b, f, h, w, c = sample.shape
        ch, layers = cfg["block_out_channels"], cfg["layers_per_block"]
        te, ae = self.time_embedding, self.add_embedding
        emb = te.linear_2(F.silu(te.linear_1(timestep_embedding(t.reshape(-1).expand(b), ch[0]))))
        ids = timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"]).reshape(b, -1)
        emb = (emb + ae.linear_2(F.silu(ae.linear_1(ids)))).repeat_interleave(f, dim=0)
        ctx = embeds.repeat_interleave(f, dim=0)
        x = self.conv_in(sample.reshape(b * f, h, w, c))
        skips = [x]
        for i in range(len(ch)):
            block = getattr(self, f"down_blocks_{i}")
            for j in range(layers):
                x = self._layer(block, j, x, emb, ctx, f)
                skips.append(x)
            if hasattr(block, "downsamplers_0"):
                x = block.downsamplers_0.conv(x)
                skips.append(x)
        x = self._layer(self.mid_block, 0, x, emb, ctx, f)
        x = self.mid_block.resnets_1(x, f, emb)
        for i in range(len(ch)):
            block = getattr(self, f"up_blocks_{i}")
            for j in range(layers + 1):
                x = self._layer(block, j, torch.cat([x, skips.pop()], dim=-1), emb, ctx, f)
            if hasattr(block, "upsamplers_0"):
                x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest").permute(0, 2, 3, 1)
                x = block.upsamplers_0.conv(x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, f, h, w, cfg["out_channels"])


class TemporalDecoder(nn.Module):
    def __init__(self, vcfg, prec):
        super().__init__()
        rev, g, n = tuple(reversed(vcfg["block_out_channels"])), vcfg["norm_num_groups"], vcfg["layers_per_block"]
        res = lambda cin, cout: STResnet(cin, cout, None, 1e-6, g, prec, temporal_eps=1e-5, switch=True)  # noqa: E731
        self.shape = (len(rev), n)
        self.conv_in = Conv(vcfg["latent_channels"], rev[0], 3, padding=1, prec=prec)
        self.mid_resnets_0, self.mid_attn, self.mid_resnets_1 = res(rev[0], rev[0]), VAEAttn(rev[0], g, prec), \
            res(rev[0], rev[0])
        cin = rev[0]
        for i, c in enumerate(rev):
            for j in range(n + 1):
                self.add_module(f"up_{i}_resnets_{j}", res(cin, c))
                cin = c
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", nn.Module())
                getattr(self, f"up_{i}_upsample").conv = Conv(c, c, 3, padding=1, prec=prec)
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = Conv(rev[-1], vcfg["out_channels"], 3, padding=1, prec=prec)
        self.time_conv_out = Conv3(vcfg["out_channels"], vcfg["out_channels"], prec)

    def forward(self, z, frames):
        blocks, n = self.shape
        x = self.mid_resnets_0(self.conv_in(z), frames)
        x = self.mid_resnets_1(self.mid_attn(x), frames)
        for i in range(blocks):
            for j in range(n + 1):
                x = getattr(self, f"up_{i}_resnets_{j}")(x, frames)
            if i < blocks - 1:
                x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest").permute(0, 2, 3, 1)
                x = getattr(self, f"up_{i}_upsample").conv(x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        bf, h, w, c = x.shape
        return self.time_conv_out(x.reshape(bf // frames, frames, h * w, c)).reshape(bf, h, w, c)


class VAE(nn.Module):
    def __init__(self, vcfg: dict, prec: Precision = EXACT):
        super().__init__()
        lc = vcfg["latent_channels"]
        self.encoder = Encoder(vcfg, prec)
        self.quant_conv = Conv(2 * lc, 2 * lc, 1, prec=prec)
        self.decoder = TemporalDecoder(vcfg, prec)

    def encode_mean(self, x):
        return self.quant_conv(self.encoder(x)).chunk(2, dim=-1)[0]


def build(model_cfg: dict, prec: Precision = EXACT) -> dict:
    """The three models of a configuration file's ``model`` group, their
    parameters on the meta device (``weights.load`` fills them)."""
    return {"unet": UNet(model_cfg["unet"], prec), "vae": VAE(model_cfg["vae"], prec),
            "image_encoder": VisionEncoder(model_cfg["image_encoder"], prec)}


def reference_models(model_cfg: dict, weights: dict, device, prec: Optional[Precision] = None) -> dict:
    from portbench import weights as W

    models = build(model_cfg, EXACT if prec is None else prec)
    W.load(models, {k: v.to(device) for k, v in weights.items()}, dtype=torch.float32)
    return models


# ---------------------------------------------------------------------------
# the request
# ---------------------------------------------------------------------------


def gaussian_taps(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size // 2)
    k = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def resize_antialiased(x: torch.Tensor, size: int) -> torch.Tensor:
    """``(N, C, H, W)`` -> ``(N, C, size, size)``: per axis a reflect-padded
    Gaussian blur (sigma ``max((H / size - 1) / 2, 0.001)``, ``max(4 sigma,
    3)`` taps rounded down, then up to odd), then bicubic with aligned
    corners (diffusers' ``_resize_with_antialiasing``)."""
    n, c, h, w = x.shape
    for axis, factor in ((3, w / size), (2, h / size)):
        sigma = max((factor - 1.0) / 2.0, 0.001)
        taps = int(max(2.0 * 2 * sigma, 3))
        taps += 1 - taps % 2
        k = gaussian_taps(taps, sigma, x.device)
        shape = (c, 1, 1, taps) if axis == 3 else (c, 1, taps, 1)
        pad = (taps // 2, taps // 2, 0, 0) if axis == 3 else (0, 0, taps // 2, taps // 2)
        x = F.conv2d(F.pad(x, pad, mode="reflect"), k.view(1, 1, -1).expand(c, 1, taps).reshape(shape), groups=c)
    return F.interpolate(x, size=(size, size), mode="bicubic", align_corners=True)


def karras(sched: dict, steps: int):
    """``(sigmas (steps + 1,), c_noise (steps,))``, fp32: Karras' ramp from
    ``sigma_max`` to ``sigma_min`` with 0 appended, and ``0.25 ln sigma``."""
    ramp = np.linspace(0.0, 1.0, steps, dtype=np.float64)
    lo, hi = sched["sigma_min"] ** (1.0 / sched["rho"]), sched["sigma_max"] ** (1.0 / sched["rho"])
    sig = (hi + ramp * (lo - hi)) ** sched["rho"]
    return (torch.from_numpy(np.append(sig, 0.0).astype(np.float32)),
            torch.from_numpy((0.25 * np.log(sig)).astype(np.float32)))


@torch.no_grad()
def clip(models: dict, model_cfg: dict, req: dict, device):
    """``(frames (1, F, H, W, 3) uint8, latents (1, F, h, w, 4) fp32)`` of
    one request: ``req`` holds ``image`` (H, W, 3) uint8, ``seed``,
    ``frames``, ``steps``, ``min_guidance``, ``max_guidance``, ``fps``,
    ``motion_bucket_id``, ``noise_aug_strength`` and ``decode_chunk``."""
    vae, unet = models["vae"], models["unet"]
    vcfg = model_cfg["vae"]
    x01 = torch.as_tensor(req["image"].astype(np.float32) / 255.0, device=device)[None]
    px = resize_antialiased(x01.permute(0, 3, 1, 2) * 2.0 - 1.0, model_cfg["image_encoder"]["image_size"])
    px = ((px + 1.0) / 2.0).permute(0, 2, 3, 1)
    mean, std = torch.tensor(CLIP_MEAN, device=device), torch.tensor(CLIP_STD, device=device)
    token = models["image_encoder"]((px - mean) / std)[:, None]
    embeds = torch.cat([torch.zeros_like(token), token])

    gen = torch.Generator(device=device).manual_seed(int(req["seed"]))
    pixels = x01 * 2.0 - 1.0
    noise = torch.randn(pixels.shape, generator=gen, device=device)
    cond = vae.encode_mean(pixels + req["noise_aug_strength"] * noise)
    frames, (_, h, w, lc) = req["frames"], cond.shape
    image_latents = torch.cat([torch.zeros_like(cond), cond])[:, None].expand(2, frames, h, w, lc)
    time_ids = torch.tensor([[req["fps"] - 1, req["motion_bucket_id"], req["noise_aug_strength"]]] * 2,
                            dtype=torch.float32, device=device)
    sigmas, c_noise = (t.to(device) for t in karras(model_cfg["scheduler"], req["steps"]))
    lat = torch.randn((1, frames, h, w, lc), generator=gen, device=device) * math.sqrt(float(sigmas[0]) ** 2 + 1.0)
    guidance = torch.linspace(req["min_guidance"], req["max_guidance"], frames, device=device).view(1, frames, 1, 1, 1)
    for i in range(req["steps"]):
        sigma, nxt = sigmas[i], sigmas[i + 1]
        x = lat / (sigma ** 2 + 1.0).sqrt()
        v = unet(torch.cat([torch.cat([x, x]), image_latents], dim=-1), c_noise[i], embeds, time_ids)
        uncond, cond_v = v.chunk(2)
        v = uncond + guidance * (cond_v - uncond)
        x0 = -sigma / (sigma ** 2 + 1.0).sqrt() * v + lat / (sigma ** 2 + 1.0)
        lat = lat + (lat - x0) / sigma * (nxt - sigma)
    z = lat.reshape(frames, h, w, lc) / vcfg["scaling_factor"]
    chunk = req["decode_chunk"]
    video = torch.cat([vae.decoder(z[i:i + chunk], z[i:i + chunk].shape[0]) for i in range(0, frames, chunk)])
    video = video.reshape(1, frames, *video.shape[1:]).cpu().numpy()
    return (np.clip(video / 2.0 + 0.5, 0.0, 1.0) * 255.0).round().astype(np.uint8), lat
