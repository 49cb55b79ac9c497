"""Synthetic diffusers-layout checkpoint directories for the PyTorch port.

The port's own writer (numpy, torch and the port's config; no JAX), with
the key names, shapes and layout of ``tests/synth.py`` (built independently
of the converter's rules): ``unet/``, ``motion_adapter/``, ``vae/``,
``text_encoder/``, ``image_encoder/`` (``diffusion_pytorch_model.
safetensors`` each), ``ip_adapter/ip-adapter.bin`` (a nested torch dict),
``tokenizer/`` and ``model_config.json``; and a training task's adapter
checkpoint ``<checkpoint_dir>/<task>/epoch_<n>/i2v_adapter/``.

Values are seeded and fan-in scaled, as ``utils.random_init.randomize_``
draws them, so that a full-width model stays finite: matrices N(0, 1 /
fan_in), norm scales 1 + 0.1 N, other vectors 0.1 N.  They are drawn with
torch on ``device`` (the card writes a full-width directory in seconds) and
stored as float32 or float16.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from i2v_adapter_tpu_torch.utils.safetensors_io import save_file
from i2v_adapter_tpu_torch.utils.tokenizer import make_test_tokenizer


class Draw:
    """Seeded fan-in-scaled tensors, returned as numpy arrays of ``dtype``."""

    def __init__(self, seed: int, dtype=np.float32, device="cpu"):
        self.dtype, self.device = np.dtype(dtype), torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def __call__(self, shape, kind: str) -> np.ndarray:
        x = torch.randn(shape, generator=self.gen, device=self.device)
        if kind == "matrix":
            x = x / math.sqrt(math.prod(shape[1:]))
        elif kind == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        return x.to(torch.float16 if self.dtype == np.float16 else torch.float32).cpu().numpy()


def _writers(draw, sd):
    def lin(name, i, o, bias=True, to=None):
        to = sd if to is None else to
        to[f"{name}.weight"] = draw((o, i), "matrix")
        if bias:
            to[f"{name}.bias"] = draw((o,), "bias")

    def conv(name, i, o, k=3, to=None):
        to = sd if to is None else to
        to[f"{name}.weight"] = draw((o, i, k, k), "matrix")
        to[f"{name}.bias"] = draw((o,), "bias")

    def norm(name, c, to=None):
        to = sd if to is None else to
        to[f"{name}.weight"] = draw((c,), "scale")
        to[f"{name}.bias"] = draw((c,), "bias")

    return lin, conv, norm


def make_unet_sd(draw, cfg):
    """(unet_sd, motion_sd, ip_sd) at ``cfg`` (a ``VideoUNetConfig``) with
    the standard IP-Adapter head."""
    sd, motion, ip = {}, {}, {"image_proj": {}, "ip_adapter": {}}
    lin, conv, norm = _writers(draw, sd)

    def attn(name, dim, ctx=None, to=None):
        ctx = ctx or dim
        lin(f"{name}.to_q", dim, dim, bias=False, to=to)
        lin(f"{name}.to_k", ctx, dim, bias=False, to=to)
        lin(f"{name}.to_v", ctx, dim, bias=False, to=to)
        lin(f"{name}.to_out.0", dim, dim, to=to)

    def tblock(name, dim, ctx, to=None):
        for n in ("norm1", "norm2", "norm3"):
            norm(f"{name}.{n}", dim, to=to)
        attn(f"{name}.attn1", dim, to=to)
        attn(f"{name}.attn2", dim, ctx, to=to)
        lin(f"{name}.ff.net.0.proj", dim, dim * 8, to=to)
        lin(f"{name}.ff.net.2", dim * 4, dim, to=to)

    def spatial(name, ch):
        norm(f"{name}.norm", ch)
        conv(f"{name}.proj_in", ch, ch, 1)
        tblock(f"{name}.transformer_blocks.0", ch, cfg.cross_attention_dim)
        conv(f"{name}.proj_out", ch, ch, 1)

    def temporal(name, ch):
        norm(f"{name}.norm", ch, to=motion)
        lin(f"{name}.proj_in", ch, ch, to=motion)
        tblock(f"{name}.transformer_blocks.0", ch, None, to=motion)
        lin(f"{name}.proj_out", ch, ch, to=motion)

    def resnet(name, ci, co):
        norm(f"{name}.norm1", ci)
        conv(f"{name}.conv1", ci, co)
        lin(f"{name}.time_emb_proj", cfg.time_embed_dim, co)
        norm(f"{name}.norm2", co)
        conv(f"{name}.conv2", co, co)
        if ci != co:
            conv(f"{name}.conv_shortcut", ci, co, 1)

    chans = cfg.block_out_channels
    conv("conv_in", cfg.in_channels, chans[0])
    lin("time_embedding.linear_1", chans[0], cfg.time_embed_dim)
    lin("time_embedding.linear_2", cfg.time_embed_dim, cfg.time_embed_dim)
    norm("conv_norm_out", chans[0])
    conv("conv_out", chans[0], cfg.out_channels)
    ci = chans[0]
    for i, ch in enumerate(chans):
        for j in range(cfg.layers_per_block):
            resnet(f"down_blocks.{i}.resnets.{j}", ci if j == 0 else ch, ch)
            if cfg.down_block_has_attention[i]:
                spatial(f"down_blocks.{i}.attentions.{j}", ch)
            temporal(f"down_blocks.{i}.motion_modules.{j}.temporal_transformer", ch)
        if i < len(chans) - 1:
            conv(f"down_blocks.{i}.downsamplers.0.conv", ch, ch)
        ci = ch
    mid = chans[-1]
    resnet("mid_block.resnets.0", mid, mid)
    resnet("mid_block.resnets.1", mid, mid)
    spatial("mid_block.attentions.0", mid)
    temporal("mid_block.motion_modules.0.temporal_transformer", mid)
    rev = list(reversed(chans))
    prev_out = rev[0]
    for i, ch in enumerate(rev):
        input_ch = rev[min(i + 1, len(rev) - 1)]
        for j in range(cfg.layers_per_block + 1):
            res_skip = input_ch if j == cfg.layers_per_block else ch
            resnet(f"up_blocks.{i}.resnets.{j}", (prev_out if j == 0 else ch) + res_skip, ch)
            if cfg.up_block_has_attention[i]:
                spatial(f"up_blocks.{i}.attentions.{j}", ch)
            temporal(f"up_blocks.{i}.motion_modules.{j}.temporal_transformer", ch)
        if i < len(rev) - 1:
            conv(f"up_blocks.{i}.upsamplers.0.conv", ch, ch)
        prev_out = ch

    d_img, d_txt = cfg.image_embed_dim, cfg.cross_attention_dim
    lin("proj", d_img, cfg.ip_num_tokens * d_txt, to=ip["image_proj"])
    norm("norm", d_txt, to=ip["image_proj"])
    _ip_sites(draw, cfg, ip["ip_adapter"])
    return sd, motion, ip


def _ip_sites(draw, cfg, out) -> None:
    """The IP-Adapter's per-site ``to_k_ip`` / ``to_v_ip`` weights, keyed by
    the attention processors' odd ids (down, up, mid)."""
    chans, d_txt = cfg.block_out_channels, cfg.cross_attention_dim
    rev = tuple(reversed(chans))
    key_id = 1
    for ch in [c for c, has in zip(chans, cfg.down_block_has_attention) if has
               for _ in range(cfg.layers_per_block)] \
            + [c for c, has in zip(rev, cfg.up_block_has_attention) if has
               for _ in range(cfg.layers_per_block + 1)] + [chans[-1]]:
        out[f"{key_id}.to_k_ip.weight"] = draw((ch, d_txt), "matrix")
        out[f"{key_id}.to_v_ip.weight"] = draw((ch, d_txt), "matrix")
        key_id += 2


def make_ip_adapter_sd(draw, model_config, variant: str, *, num_tokens: int = 16, resampler_dim: int = 768,
                       depth: int = 4) -> dict:
    """An IP-Adapter state dict ``{"image_proj", "ip_adapter"}`` in the
    original modules' key layout of ``variant``: the plus resampler
    (``num_tokens`` latents of ``resampler_dim``, ``depth`` layers; the
    published plus head is 16 x 768, depth 4) or the full_face MLP, each
    reading the image encoder's hidden states (the standard head is
    ``make_unet_sd``'s)."""
    ucfg, hidden = model_config.unet, model_config.image_encoder.hidden_size
    d_txt = ucfg.cross_attention_dim
    proj = {}
    lin, _, norm = _writers(draw, proj)
    if variant == "full_face":  # nn.Sequential(Linear, GELU, Linear, LayerNorm)
        lin("proj.0", hidden, hidden)
        lin("proj.2", hidden, d_txt)
        norm("proj.3", d_txt)
    elif variant == "plus":
        dim = resampler_dim
        proj["latents"] = draw((1, num_tokens, dim), "bias")
        lin("proj_in", hidden, dim)
        lin("proj_out", dim, d_txt)
        norm("norm_out", d_txt)
        for i in range(depth):
            norm(f"layers.{i}.0.norm1", dim)
            norm(f"layers.{i}.0.norm2", dim)
            lin(f"layers.{i}.0.to_q", dim, dim, bias=False)
            lin(f"layers.{i}.0.to_kv", dim, 2 * dim, bias=False)
            lin(f"layers.{i}.0.to_out", dim, dim, bias=False)
            norm(f"layers.{i}.1.0", dim)
            lin(f"layers.{i}.1.1", dim, 4 * dim, bias=False)
            lin(f"layers.{i}.1.3", 4 * dim, dim, bias=False)
    else:
        raise ValueError(f"unknown IP-Adapter variant {variant!r}")
    sites = {}
    _ip_sites(draw, ucfg, sites)
    return {"image_proj": proj, "ip_adapter": sites}


def save_ip_adapter(ip_sd: dict, path: str) -> int:
    """Write an IP-Adapter state dict as the nested torch ``.bin`` of the
    published checkpoints; returns its size in bytes."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({part: {k: torch.from_numpy(v) for k, v in ip_sd[part].items()}
                for part in ("image_proj", "ip_adapter")}, path)
    return os.path.getsize(path)


def make_adapter_sd(draw, cfg):
    """A trained-looking I2V adapter (nonzero Q/K/V/out at every spatial
    transformer block) in the torch I2VAdapterModule layout."""
    sd = {}
    lin = _writers(draw, sd)[0]
    rev = list(reversed(cfg.block_out_channels))
    sites = [(f"down_blocks.{i}.attentions.{j}", ch)
             for i, (ch, has) in enumerate(zip(cfg.block_out_channels, cfg.down_block_has_attention)) if has
             for j in range(cfg.layers_per_block)]
    sites += [("mid_block.attentions.0", rev[0])]
    sites += [(f"up_blocks.{i}.attentions.{j}", ch)
              for i, (ch, has) in enumerate(zip(rev, cfg.up_block_has_attention)) if has
              for j in range(cfg.layers_per_block + 1)]
    for site, ch in sites:
        for k in range(cfg.transformer_layers_per_block):
            base = f"{site}.transformer_blocks.{k}.i2v_adapter"
            for proj in ("to_q", "to_k", "to_v"):
                lin(f"{base}.{proj}", ch, ch, bias=False)
            lin(f"{base}.to_out.0", ch, ch)
    return sd


def make_vae_sd(draw, cfg):
    sd = {}
    lin, conv, norm = _writers(draw, sd)

    def resnet(name, ci, co):
        norm(f"{name}.norm1", ci)
        conv(f"{name}.conv1", ci, co)
        norm(f"{name}.norm2", co)
        conv(f"{name}.conv2", co, co)
        if ci != co:
            conv(f"{name}.conv_shortcut", ci, co, 1)

    def mid(part, m):
        resnet(f"{part}.mid_block.resnets.0", m, m)
        norm(f"{part}.mid_block.attentions.0.group_norm", m)
        for p in ("to_q", "to_k", "to_v", "to_out.0"):
            lin(f"{part}.mid_block.attentions.0.{p}", m, m)
        resnet(f"{part}.mid_block.resnets.1", m, m)

    ch = cfg.block_out_channels
    conv("encoder.conv_in", 3, ch[0])
    ci = ch[0]
    for i, c in enumerate(ch):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", ci if j == 0 else c, c)
        if i < len(ch) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c)
        ci = c
    m = ch[-1]
    mid("encoder", m)
    norm("encoder.conv_norm_out", m)
    conv("encoder.conv_out", m, 2 * cfg.latent_channels)
    conv("decoder.conv_in", cfg.latent_channels, m)
    mid("decoder", m)
    rev = list(reversed(ch))
    ci = m
    for i, c in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", ci if j == 0 else c, c)
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c)
        ci = c
    norm("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", rev[-1], cfg.out_channels)
    conv("quant_conv", 2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
    conv("post_quant_conv", cfg.latent_channels, cfg.latent_channels, 1)
    return sd


def _clip_layers(draw, sd, prefix, hidden, inter, layers):
    lin, _, norm = _writers(draw, sd)
    for i in range(layers):
        base = f"{prefix}.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{base}.self_attn.{proj}", hidden, hidden)
        norm(f"{base}.layer_norm1", hidden)
        norm(f"{base}.layer_norm2", hidden)
        lin(f"{base}.mlp.fc1", hidden, inter)
        lin(f"{base}.mlp.fc2", inter, hidden)


def make_clip_text_sd(draw, cfg):
    sd, p = {}, "text_model."
    sd[f"{p}embeddings.token_embedding.weight"] = draw((cfg.vocab_size, cfg.hidden_size), "matrix")
    sd[f"{p}embeddings.position_embedding.weight"] = draw(
        (cfg.max_position_embeddings, cfg.hidden_size), "matrix")
    _clip_layers(draw, sd, f"{p}encoder", cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers)
    _writers(draw, sd)[2](f"{p}final_layer_norm", cfg.hidden_size)
    return sd


def make_clip_vision_sd(draw, cfg):
    sd, p = {}, "vision_model."
    sd[f"{p}embeddings.patch_embedding.weight"] = draw(
        (cfg.hidden_size, 3, cfg.patch_size, cfg.patch_size), "matrix")
    sd[f"{p}embeddings.class_embedding"] = draw((cfg.hidden_size,), "bias")
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    sd[f"{p}embeddings.position_embedding.weight"] = draw((n_patches + 1, cfg.hidden_size), "matrix")
    norm = _writers(draw, sd)[2]
    norm(f"{p}pre_layrnorm", cfg.hidden_size)
    norm(f"{p}post_layernorm", cfg.hidden_size)
    _clip_layers(draw, sd, f"{p}encoder", cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers)
    sd["visual_projection.weight"] = draw((cfg.projection_dim, cfg.hidden_size), "matrix")
    return sd


def _save(sd, path) -> int:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return save_file(sd, path)


def write_pretrained_dir(root: str, model_config, *, seed: int = 0, dtype=np.float32, device="cpu",
                         tokenizer_length=None) -> dict:
    """Write a ``from_pretrained``-able directory at ``model_config``'s
    widths, one component at a time (each freed before the next).  The
    tokenizer pads to ``tokenizer_length`` (default: the text encoder's
    positions).  Returns ``{"bytes", "seconds"}``."""
    t0 = time.perf_counter()
    draw = Draw(seed, dtype, device)
    cfg = model_config
    unet_sd, motion_sd, ip_sd = make_unet_sd(draw, cfg.unet)
    name = "diffusion_pytorch_model.safetensors"
    total = _save(unet_sd, os.path.join(root, "unet", name))
    total += _save(motion_sd, os.path.join(root, "motion_adapter", name))
    del unet_sd, motion_sd
    total += save_ip_adapter(ip_sd, os.path.join(root, "ip_adapter", "ip-adapter.bin"))
    for sub, make, sub_cfg in (("vae", make_vae_sd, cfg.vae), ("text_encoder", make_clip_text_sd, cfg.text_encoder),
                               ("image_encoder", make_clip_vision_sd, cfg.image_encoder)):
        total += _save(make(draw, sub_cfg), os.path.join(root, sub, name))
    tok_dir = os.path.join(root, "tokenizer")
    os.makedirs(tok_dir, exist_ok=True)
    make_test_tokenizer(tok_dir)
    with open(os.path.join(tok_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": int(tokenizer_length or cfg.text_encoder.max_position_embeddings)}, f)
    with open(os.path.join(root, "model_config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)
    return {"bytes": total, "seconds": time.perf_counter() - t0}


def write_adapter_task(checkpoint_dir: str, task: str, model_config, *, epoch: int = 1, seed: int = 1,
                       dtype=np.float32, device="cpu") -> str:
    """Write ``<checkpoint_dir>/<task>/epoch_<epoch>/i2v_adapter/
    diffusion_pytorch_model.safetensors`` with nonzero adapter weights;
    returns its path."""
    path = os.path.join(checkpoint_dir, task, f"epoch_{epoch}", "i2v_adapter",
                        "diffusion_pytorch_model.safetensors")
    _save(make_adapter_sd(Draw(seed, dtype, device), model_config.unet), path)
    return path
