"""The plain reference of the benchmark's models: the SD1.5 video UNet with
AnimateDiff motion modules, the I2V-Adapter cross-frame attention and the
IP-Adapter standard branch, the SD VAE and the two CLIP towers.

Plain PyTorch in float32 on channel-last activations, with no kernel, no
cache and no batching of its own: attention is softmax(q k^T
/ sqrt(d)) v by matmuls, taken a block of the batch at a time so that the
scores fit.  The parameter names and shapes follow the published layouts as
the program under test names them (``down_blocks_0.resnets_0.conv1.weight``
and so on), so one set of seeded weights loads into both.  It imports
nothing of the program.

Every matmul and convolution goes through a ``Precision`` (``exact`` by
default).  ``lower.py`` holds the others: the serving configuration's int8
sites, and the control's, which rounds the operands of those sites to int4
and every other operand to float8.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# the largest attention-score block held at once, in bytes
SCORE_BLOCK_BYTES = 1 << 30


class Precision:
    """Exact float32: operands pass unchanged.  ``kind`` is ``"int"`` at the
    sites the configuration runs in int8 and ``"fp"`` elsewhere."""

    def act(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        return x

    def weight(self, w: torch.Tensor, kind: str) -> torch.Tensor:
        return w


EXACT = Precision()


class Lin(nn.Linear):
    """``nn.Linear`` on the last axis, through the model's precision."""

    def __init__(self, cin: int, cout: int, bias: bool = True, prec: Precision = EXACT):
        super().__init__(cin, cout, bias=bias, device="meta")
        self.prec = prec

    def forward(self, x):
        return F.linear(self.prec.act(x, "fp"), self.prec.weight(self.weight, "fp"), self.bias)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` (OIHW) on channel-last ``(N, H, W, C)``; ``kind`` is
    the precision's site kind."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0, bias: bool = True,
                 prec: Precision = EXACT, kind: str = "fp"):
        super().__init__(cin, cout, k, stride=stride, padding=padding, bias=bias, device="meta")
        self.prec, self.kind = prec, kind

    def forward(self, x):
        x = self.prec.act(x, self.kind)
        w = self.prec.weight(self.weight, self.kind)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """GroupNorm of ``(N, ..., C)``: statistics per sample and group over
    every non-batch position (two-pass variance)."""

    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.empty(channels, device="meta"))
        self.bias = nn.Parameter(torch.empty(channels, device="meta"))

    def forward(self, x):
        shape = x.shape
        xg = x.reshape(shape[0], -1, self.groups, shape[-1] // self.groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, unbiased=False)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(shape)
        return y * self.weight + self.bias


def layer_norm(dim: int, eps: float) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps, device="meta")


def attention(q, k, v, heads: int, prec: Precision, kv_repeat: int = 1, mask=None):
    """softmax(q k^T / sqrt(d)) v for q ``(Bq, Nq, C)`` and k, v ``(Bk, Nk,
    C)``, query batch i reading key batch ``i // kv_repeat``."""
    q, k, v = prec.act(q, "fp"), prec.act(k, "fp"), prec.act(v, "fp")
    bq, nq, c = q.shape
    nk, d = k.shape[1], c // heads
    out = torch.empty_like(q)
    step = max(1, SCORE_BLOCK_BYTES // (heads * nq * nk * 4))
    for b0 in range(0, bq, step):
        b1 = min(bq, b0 + step)
        idx = torch.arange(b0, b1, device=q.device) // kv_repeat
        qh = q[b0:b1].reshape(b1 - b0, nq, heads, d).transpose(1, 2)
        kh = k[idx].reshape(b1 - b0, nk, heads, d).transpose(1, 2)
        vh = v[idx].reshape(b1 - b0, nk, heads, d).transpose(1, 2)
        s = (qh @ kh.transpose(-1, -2)) / math.sqrt(d)
        if mask is not None:
            s = s + mask
        out[b0:b1] = (torch.softmax(s, dim=-1) @ vh).transpose(1, 2).reshape(b1 - b0, nq, c)
    return out


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, cos first (flip_sin_to_cos), no shift."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    emb = freqs[None, :] * t.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps, prec, kind):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv(cin, cout, 3, padding=1, prec=prec, kind=kind)
        if temb is not None:
            self.time_emb_proj = Lin(temb, cout, prec=prec)
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv(cout, cout, 3, padding=1, prec=prec, kind=kind)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1, prec=prec)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attn(nn.Module):
    def __init__(self, dim, heads, context=None, ip_tokens=0, ip_scale=1.0, prec=EXACT, bias_qkv=False):
        super().__init__()
        context = context or dim
        self.heads, self.ip_tokens, self.ip_scale, self.prec = heads, ip_tokens, ip_scale, prec
        self.to_q = Lin(dim, dim, bias=bias_qkv, prec=prec)
        self.to_k = Lin(context, dim, bias=bias_qkv, prec=prec)
        self.to_v = Lin(context, dim, bias=bias_qkv, prec=prec)
        if ip_tokens:
            self.to_k_ip = Lin(context, dim, bias=False, prec=prec)
            self.to_v_ip = Lin(context, dim, bias=False, prec=prec)
        self.to_out = Lin(dim, dim, prec=prec)

    def forward(self, x, ctx=None, kv_repeat=1):
        ctx = x if ctx is None else ctx
        q = self.to_q(x)
        text = ctx[:, :ctx.shape[1] - self.ip_tokens] if self.ip_tokens else ctx
        out = attention(q, self.to_k(text), self.to_v(text), self.heads, self.prec, kv_repeat)
        if self.ip_tokens:
            ip = ctx[:, ctx.shape[1] - self.ip_tokens:]
            out = out + self.ip_scale * attention(q, self.to_k_ip(ip), self.to_v_ip(ip), self.heads, self.prec,
                                                  kv_repeat)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim, tanh, prec):
        super().__init__()
        self.tanh = tanh
        self.proj = Lin(dim, dim * 8, prec=prec)
        self.proj_out = Lin(dim * 4, dim, prec=prec)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate, approximate="tanh" if self.tanh else "none"))


class Block(nn.Module):
    """Spatial transformer block: self-attention plus the I2V-Adapter's
    attention from every frame to its clip's first frame, text + IP
    cross-attention, GEGLU."""

    def __init__(self, dim, heads, ucfg, prec):
        super().__init__()
        self.norm1 = layer_norm(dim, 1e-5)
        self.attn1 = Attn(dim, heads, prec=prec)
        self.i2v = ucfg["use_i2v_adapter"]
        if self.i2v:
            self.i2v_adapter = Attn(dim, heads, prec=prec)
        ip = ucfg["ip_num_tokens"] if ucfg["use_ip_adapter"] else 0
        self.norm2 = layer_norm(dim, 1e-5)
        self.attn2 = Attn(dim, heads, context=ucfg["cross_attention_dim"], ip_tokens=ip,
                          ip_scale=ucfg["ip_scale"], prec=prec)
        self.norm3 = layer_norm(dim, 1e-5)
        self.ff = GEGLU(dim, ucfg["fast_gelu"], prec)

    def forward(self, x, ctx, frames, cross_frame):
        n = self.norm1(x)
        out = self.attn1(n)
        if self.i2v and cross_frame:
            first = n.view(n.shape[0] // frames, frames, *n.shape[1:])[:, 0]
            out = out + self.i2v_adapter(n, first, kv_repeat=frames)
        x = x + out
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Spatial(nn.Module):
    def __init__(self, ch, ucfg, prec):
        super().__init__()
        self.norm = GroupNorm(ucfg["norm_num_groups"], ch, 1e-6)
        if ucfg["use_linear_projection"]:
            self.proj_in, self.proj_out = Lin(ch, ch, prec=prec), Lin(ch, ch, prec=prec)
        else:
            self.proj_in, self.proj_out = Conv(ch, ch, 1, prec=prec), Conv(ch, ch, 1, prec=prec)
        self.layers = ucfg["transformer_layers_per_block"]
        for i in range(self.layers):
            self.add_module(f"transformer_blocks_{i}", Block(ch, ucfg["num_attention_heads"], ucfg, prec))

    def forward(self, x, ctx, frames, cross_frame):
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x)).reshape(b, h * w, c)
        for i in range(self.layers):
            y = getattr(self, f"transformer_blocks_{i}")(y, ctx, frames, cross_frame)
        return self.proj_out(y.reshape(b, h, w, c)) + x


def frame_positions(f: int, dim: int, device) -> torch.Tensor:
    """Interleaved sin / cos positions of the motion module's frames."""
    pos = torch.arange(f, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros(f, dim, device=device)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
    return pe


class FrameAttn(nn.Module):
    """Self-attention over the frame axis of ``(B, F, S, C)``."""

    def __init__(self, dim, heads, prec):
        super().__init__()
        self.heads, self.prec = heads, prec
        self.to_q = Lin(dim, dim, bias=False, prec=prec)
        self.to_k = Lin(dim, dim, bias=False, prec=prec)
        self.to_v = Lin(dim, dim, bias=False, prec=prec)
        self.to_out = Lin(dim, dim, prec=prec)

    def forward(self, x):
        b, f, s, c = x.shape
        tok = lambda t: t.permute(0, 2, 1, 3).reshape(b * s, f, c)  # noqa: E731
        out = attention(tok(self.to_q(x)), tok(self.to_k(x)), tok(self.to_v(x)), self.heads, self.prec)
        return self.to_out(out.reshape(b, s, f, c).permute(0, 2, 1, 3))


class MotionBlock(nn.Module):
    def __init__(self, dim, heads, tanh, prec):
        super().__init__()
        self.norm1, self.attn1 = layer_norm(dim, 1e-5), FrameAttn(dim, heads, prec)
        self.norm2, self.attn2 = layer_norm(dim, 1e-5), FrameAttn(dim, heads, prec)
        self.norm3, self.ff = layer_norm(dim, 1e-5), GEGLU(dim, tanh, prec)

    def forward(self, x):
        pe = frame_positions(x.shape[1], x.shape[-1], x.device)[None, :, None, :]
        x = x + self.attn1(self.norm1(x) + pe)
        x = x + self.attn2(self.norm2(x) + pe)
        return x + self.ff(self.norm3(x))


class Motion(nn.Module):
    """AnimateDiff motion module: GroupNorm jointly over a clip's frames,
    frame attention per spatial token."""

    def __init__(self, ch, ucfg, prec):
        super().__init__()
        self.norm = GroupNorm(ucfg["norm_num_groups"], ch, 1e-6)
        self.proj_in = Lin(ch, ch, prec=prec)
        self.transformer_blocks_0 = MotionBlock(ch, ucfg["motion_num_attention_heads"], ucfg["fast_gelu"], prec)
        self.proj_out = Lin(ch, ch, prec=prec)

    def forward(self, x, frames):
        bf, h, w, c = x.shape
        t = self.norm(x.reshape(bf // frames, frames * h * w, c)).reshape(bf // frames, frames, h * w, c)
        t = self.proj_out(self.transformer_blocks_0(self.proj_in(t)))
        return t.reshape(bf, h, w, c) + x


class Stage(nn.Module):
    """A down, mid or up block: resnet (+ spatial transformer) + motion per
    layer, then the resampling conv."""

    def __init__(self, resnet_in, cout, attn, ucfg, prec, resample=None, mid=False):
        super().__init__()
        self.n, self.attn, self.mid = len(resnet_in), attn, mid
        self.motion = ucfg["use_motion_modules"] and (not mid or ucfg["use_motion_mid_block"])
        kind = "int" if ucfg["int8_conv"] else "fp"
        for i, cin in enumerate(resnet_in):
            self.add_module(f"resnets_{i}", Resnet(cin, cout, ucfg["block_out_channels"][0] * 4,
                                                   ucfg["norm_num_groups"], ucfg["norm_eps"], prec, kind))
            if attn and (not mid or i == 0):
                self.add_module(f"attentions_{i}", Spatial(cout, ucfg, prec))
            if self.motion and (not mid or i == 0):
                self.add_module(f"motion_modules_{i}", Motion(cout, ucfg, prec))
        self.resample = resample
        if resample == "down":
            self.downsamplers_0 = nn.Module()
            self.downsamplers_0.conv = Conv(cout, cout, 3, stride=2, padding=1, prec=prec, kind=kind)
        elif resample == "up":
            self.upsamplers_0 = nn.Module()
            self.upsamplers_0.conv = Conv(cout, cout, 3, padding=1, prec=prec, kind=kind)

    def _attend(self, i, x, ctx, frames, cross_frame):
        if hasattr(self, f"attentions_{i}"):
            x = getattr(self, f"attentions_{i}")(x, ctx, frames, cross_frame)
        if hasattr(self, f"motion_modules_{i}"):
            x = getattr(self, f"motion_modules_{i}")(x, frames)
        return x

    def forward(self, x, temb, ctx, frames, cross_frame, skips=None):
        if self.mid:
            x = self._attend(0, self.resnets_0(x, temb), ctx, frames, cross_frame)
            return self.resnets_1(x, temb)
        out = []
        for i in range(self.n):
            if skips is not None:
                x = torch.cat([x, skips.pop()], dim=-1)
            x = self._attend(i, getattr(self, f"resnets_{i}")(x, temb), ctx, frames, cross_frame)
            out.append(x)
        if self.resample == "down":
            x = self.downsamplers_0.conv(x)
            out.append(x)
        elif self.resample == "up":
            x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest").permute(0, 2, 3, 1)
            x = self.upsamplers_0.conv(x)
        return x, out


class VideoUNet(nn.Module):
    """``forward(sample (B, F, H, W, 4), t (B,), text (B, L, C), image_embeds
    (B, D)) -> (B, F, H, W, 4)``; ``ucfg`` is the configuration file's
    ``unet`` group."""

    def __init__(self, ucfg: dict, prec: Precision = EXACT):
        super().__init__()
        if ucfg["ip_variant"] != "standard" or ucfg["freeu"] is not None:
            raise ValueError("the reference covers the standard IP head without FreeU")
        self.cfg = ucfg
        ch = ucfg["block_out_channels"]
        n, layers, temb = len(ch), ucfg["layers_per_block"], ch[0] * 4
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Lin(ch[0], temb, prec=prec)
        self.time_embedding.linear_2 = Lin(temb, temb, prec=prec)
        if ucfg["use_ip_adapter"]:
            self.encoder_hid_proj = nn.Module()
            self.encoder_hid_proj.proj = Lin(ucfg["image_embed_dim"],
                                             ucfg["ip_num_tokens"] * ucfg["cross_attention_dim"], prec=prec)
            self.encoder_hid_proj.norm = layer_norm(ucfg["cross_attention_dim"], 1e-6)
        self.conv_in = Conv(ucfg["in_channels"], ch[0], 3, padding=1, prec=prec)
        skip_ch, cin = [ch[0]], ch[0]
        for i in range(n):
            self.add_module(f"down_blocks_{i}", Stage(
                [cin] + [ch[i]] * (layers - 1), ch[i], ucfg["down_block_has_attention"][i], ucfg, prec,
                "down" if i < n - 1 else None))
            skip_ch += [ch[i]] * (layers + (1 if i < n - 1 else 0))
            cin = ch[i]
        self.mid_block = Stage([ch[-1], ch[-1]], ch[-1], True, ucfg, prec, mid=True)
        x_ch = ch[-1]
        for i, out in enumerate(reversed(ch)):
            block, skip_ch = skip_ch[-(layers + 1):], skip_ch[:-(layers + 1)]
            resnet_in = [(x_ch if j == 0 else out) + block[-(j + 1)] for j in range(layers + 1)]
            self.add_module(f"up_blocks_{i}", Stage(resnet_in, out, ucfg["up_block_has_attention"][i], ucfg, prec,
                                                    "up" if i < n - 1 else None))
            x_ch = out
        self.conv_norm_out = GroupNorm(ucfg["norm_num_groups"], ch[0], ucfg["norm_eps"])
        self.conv_out = Conv(ch[0], ucfg["out_channels"], 3, padding=1, prec=prec)

    def forward(self, sample, t, text, image_embeds=None, cross_frame=True):
        cfg = self.cfg
        b, f, h, w, c = sample.shape
        te = self.time_embedding
        emb = te.linear_2(F.silu(te.linear_1(timestep_embedding(t.reshape(-1).expand(b),
                                                                  cfg["block_out_channels"][0]))))
        emb = emb.repeat_interleave(f, dim=0)
        if cfg["use_ip_adapter"]:
            p = self.encoder_hid_proj
            tokens = p.proj(image_embeds).reshape(b, cfg["ip_num_tokens"], cfg["cross_attention_dim"])
            text = torch.cat([text, p.norm(tokens)], dim=1)
        ctx = text.repeat_interleave(f, dim=0)
        x = self.conv_in(sample.reshape(b * f, h, w, c))
        skips = [x]
        n = len(cfg["block_out_channels"])
        for i in range(n):
            x, out = getattr(self, f"down_blocks_{i}")(x, emb, ctx, f, cross_frame)
            skips += out
        x = self.mid_block(x, emb, ctx, f, cross_frame)
        for i in range(n):
            x, _ = getattr(self, f"up_blocks_{i}")(x, emb, ctx, f, cross_frame, skips=skips)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, f, h, w, cfg["out_channels"])


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


class VAEAttn(nn.Module):
    def __init__(self, ch, groups, prec):
        super().__init__()
        self.prec = prec
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q, self.to_k = Lin(ch, ch, prec=prec), Lin(ch, ch, prec=prec)
        self.to_v, self.to_out = Lin(ch, ch, prec=prec), Lin(ch, ch, prec=prec)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        y = attention(self.to_q(y), self.to_k(y), self.to_v(y), 1, self.prec)
        return x + self.to_out(y).reshape(b, h, w, c)


class Encoder(nn.Module):
    def __init__(self, vcfg, prec):
        super().__init__()
        ch, g, n = vcfg["block_out_channels"], vcfg["norm_num_groups"], vcfg["layers_per_block"]
        self.shape = (len(ch), n)
        self.conv_in = Conv(vcfg["in_channels"], ch[0], 3, padding=1, prec=prec)
        cin = ch[0]
        for i, c in enumerate(ch):
            for j in range(n):
                self.add_module(f"down_{i}_resnets_{j}", Resnet(cin, c, None, g, 1e-6, prec, "fp"))
                cin = c
            if i < len(ch) - 1:
                self.add_module(f"down_{i}_downsample", nn.Module())
                getattr(self, f"down_{i}_downsample").conv = Conv(c, c, 3, stride=2, prec=prec)
        self.mid_resnets_0 = Resnet(ch[-1], ch[-1], None, g, 1e-6, prec, "fp")
        self.mid_attn = VAEAttn(ch[-1], g, prec)
        self.mid_resnets_1 = Resnet(ch[-1], ch[-1], None, g, 1e-6, prec, "fp")
        self.conv_norm_out = GroupNorm(g, ch[-1], 1e-6)
        self.conv_out = Conv(ch[-1], 2 * vcfg["latent_channels"], 3, padding=1, prec=prec)

    def forward(self, x):
        blocks, n = self.shape
        x = self.conv_in(x)
        for i in range(blocks):
            for j in range(n):
                x = getattr(self, f"down_{i}_resnets_{j}")(x)
            if i < blocks - 1:
                x = getattr(self, f"down_{i}_downsample").conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        x = self.mid_resnets_1(self.mid_attn(self.mid_resnets_0(x)))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, vcfg, prec):
        super().__init__()
        rev, g, n = tuple(reversed(vcfg["block_out_channels"])), vcfg["norm_num_groups"], vcfg["layers_per_block"]
        kind = "int" if vcfg["int8_decode"] else "fp"
        self.shape = (len(rev), n)
        self.conv_in = Conv(vcfg["latent_channels"], rev[0], 3, padding=1, prec=prec)
        self.mid_resnets_0 = Resnet(rev[0], rev[0], None, g, 1e-6, prec, kind)
        self.mid_attn = VAEAttn(rev[0], g, prec)
        self.mid_resnets_1 = Resnet(rev[0], rev[0], None, g, 1e-6, prec, kind)
        cin = rev[0]
        for i, c in enumerate(rev):
            for j in range(n + 1):
                self.add_module(f"up_{i}_resnets_{j}", Resnet(cin, c, None, g, 1e-6, prec, kind))
                cin = c
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", nn.Module())
                getattr(self, f"up_{i}_upsample").conv = Conv(c, c, 3, padding=1, prec=prec, kind=kind)
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = Conv(rev[-1], vcfg["out_channels"], 3, padding=1, prec=prec)

    def forward(self, z):
        blocks, n = self.shape
        x = self.mid_resnets_1(self.mid_attn(self.mid_resnets_0(self.conv_in(z))))
        for i in range(blocks):
            for j in range(n + 1):
                x = getattr(self, f"up_{i}_resnets_{j}")(x)
            if i < blocks - 1:
                x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest").permute(0, 2, 3, 1)
                x = getattr(self, f"up_{i}_upsample").conv(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    def __init__(self, vcfg: dict, prec: Precision = EXACT):
        super().__init__()
        self.cfg = vcfg
        lc = vcfg["latent_channels"]
        self.encoder = Encoder(vcfg, prec)
        self.decoder = Decoder(vcfg, prec)
        self.quant_conv = Conv(2 * lc, 2 * lc, 1, prec=prec)
        self.post_quant_conv = Conv(lc, lc, 1, prec=prec)

    def encode(self, x, noise):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * noise

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


class ClipLayer(nn.Module):
    def __init__(self, hidden, heads, inter, act, eps, prec):
        super().__init__()
        self.heads, self.act, self.prec = heads, act, prec
        self.layer_norm1 = layer_norm(hidden, eps)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, Lin(hidden, hidden, prec=prec))
        self.layer_norm2 = layer_norm(hidden, eps)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = Lin(hidden, inter, prec=prec), Lin(inter, hidden, prec=prec)

    def forward(self, x, mask=None):
        a, h = self.self_attn, self.layer_norm1(x)
        x = x + a.out_proj(attention(a.q_proj(h), a.k_proj(h), a.v_proj(h), self.heads, self.prec, mask=mask))
        h = self.mlp.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp.fc2(h)


def _clip_layers(module, cfg, prec):
    for i in range(cfg["num_hidden_layers"]):
        module.add_module(f"layers_{i}", ClipLayer(cfg["hidden_size"], cfg["num_attention_heads"],
                                                   cfg["intermediate_size"], cfg["hidden_act"],
                                                   cfg["layer_norm_eps"], prec))


class TextEncoder(nn.Module):
    """Token ids ``(B, L)`` -> final-LayerNorm hidden states, causal."""

    def __init__(self, cfg: dict, prec: Precision = EXACT):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"], device="meta")
        self.position_embedding = nn.Parameter(torch.empty(cfg["max_position_embeddings"], cfg["hidden_size"],
                                                           device="meta"))
        _clip_layers(self, cfg, prec)
        self.final_layer_norm = layer_norm(cfg["hidden_size"], cfg["layer_norm_eps"])

    def forward(self, ids):
        n = ids.shape[1]
        x = self.token_embedding(ids.long()) + self.position_embedding[None, :n]
        mask = torch.triu(torch.full((n, n), -1e9, device=x.device), diagonal=1)[None, None]
        for i in range(self.cfg["num_hidden_layers"]):
            x = getattr(self, f"layers_{i}")(x, mask)
        return self.final_layer_norm(x)


class VisionEncoder(nn.Module):
    """CLIP-normalised pixels ``(B, S, S, 3)`` -> projected embedding."""

    def __init__(self, cfg: dict, prec: Precision = EXACT):
        super().__init__()
        self.cfg = cfg
        hidden, p = cfg["hidden_size"], cfg["patch_size"]
        self.patch_embedding = Conv(3, hidden, p, stride=p, bias=False, prec=prec)
        self.class_embedding = nn.Parameter(torch.empty(hidden, device="meta"))
        self.position_embedding = nn.Parameter(torch.empty((cfg["image_size"] // p) ** 2 + 1, hidden,
                                                           device="meta"))
        self.pre_layrnorm = layer_norm(hidden, cfg["layer_norm_eps"])
        _clip_layers(self, cfg, prec)
        self.post_layernorm = layer_norm(hidden, cfg["layer_norm_eps"])
        self.visual_projection = Lin(hidden, cfg["projection_dim"], bias=False, prec=prec)

    def forward(self, pixels):
        hidden = self.cfg["hidden_size"]
        patches = self.patch_embedding(pixels)
        b = patches.shape[0]
        x = torch.cat([self.class_embedding.expand(b, 1, hidden), patches.reshape(b, -1, hidden)], dim=1)
        x = self.pre_layrnorm(x + self.position_embedding[None])
        for i in range(self.cfg["num_hidden_layers"]):
            x = getattr(self, f"layers_{i}")(x)
        return self.visual_projection(self.post_layernorm(x[:, 0]))


def build(model_cfg: dict, prec: Precision = EXACT, image: bool = True) -> dict:
    """The four models of a configuration file's ``model`` group, their
    parameters on the meta device (``weights.load`` fills them)."""
    models = {"unet": VideoUNet(model_cfg["unet"], prec), "vae": VAE(model_cfg["vae"], prec),
              "text_encoder": TextEncoder(model_cfg["text_encoder"], prec)}
    if image and model_cfg["unet"]["use_ip_adapter"]:
        models["image_encoder"] = VisionEncoder(model_cfg["image_encoder"], prec)
    return models
