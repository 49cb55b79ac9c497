"""Motion-module and VAE-decode micro-profiles.

Counterpart of the JAX package's ``ops/profile_motion.py``: stripped-down
variants of the temporal stack at the motion modules' four levels (512 px,
16 frames, B = 2: ``(64, 320)``, ``(32, 640)``, ``(16, 1280)``, ``(8,
1280)`` as (side, channels), derived from the model config), each timed as
N calls replayed from one CUDA graph between CUDA events (the JAX tool's
in-jit ``lax.scan``), then the VAE decode of 16 frames swept over
``decode_slice``.  The variants, with seeded random bf16 weights:

* ``full_motion_module`` -- the port's ``TemporalTransformer``;
* ``groupnorm_only`` -- its GroupNorm over (F*H*W, C) per clip, residual;
* ``proj_in_out_only`` -- the two linear projections, residual;
* ``temporal_attn_k2`` -- q/k/v projections and the frame attention as the
  UNet dispatches it (``impl='auto'``: K2 where S >= 128, the plain einsum
  below);
* ``temporal_attn_k6`` -- the same through the kernel at every S
  (``impl='kernel'``, the reference's forced Pallas kernel, K6);
* ``temporal_attn_plain`` -- the same through the plain einsum;
* ``geglu_ff_only`` -- LayerNorm and the GEGLU feed-forward, residual.

The JAX tool's three temporal-attention implementations are the TPU's:
``vpu`` and ``vpu2`` lower the F x F contraction to vector-unit
broadcast-multiply-reduce streams, which the card has no counterpart for
(its kernels are K2 / K6 above); ``mxu`` is the einsum, the port's
``temporal_attn_plain``.

    python -m i2v_adapter_tpu_torch.ops.profile_motion [--iters N] [--decode-slices 1,2,4,8,16] [--device cpu]

prints one JSON record per (level, variant) and per decode slice, then the
card's name and power limit.  On the CPU (``--device cpu``) every variant
runs once on plain math and reports no time.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn as nn

from i2v_adapter_tpu_torch.device import resolve_device
from i2v_adapter_tpu_torch.models.attention import FeedForward
from i2v_adapter_tpu_torch.models.layers import GroupNorm, LayerNorm, Linear
from i2v_adapter_tpu_torch.models.temporal import TemporalTransformer
from i2v_adapter_tpu_torch.ops.attention import temporal_attention
from i2v_adapter_tpu_torch.ops.profiling import card_line, emit, event_ms, graph_ms

B, F = 2, 16
N_ITERS = 16
DECODE_SLICES = (1, 2, 4, 8, 16)


class NormOnly(nn.Module):
    def __init__(self, c: int, groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(groups, c, 1e-6)

    def forward(self, x, *, num_frames: int):
        bf, h, w, c = x.shape
        t = self.norm(x.reshape(bf // num_frames, num_frames * h * w, c))
        return t.reshape(bf, h, w, c) + x


class ProjOnly(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.proj_in, self.proj_out = Linear(c, c), Linear(c, c)

    def forward(self, x, *, num_frames: int):
        return self.proj_out(self.proj_in(x)) + x


class AttnOnly(nn.Module):
    def __init__(self, c: int, heads: int, impl: str):
        super().__init__()
        self.heads, self.impl = heads, impl
        self.q, self.k, self.v = (Linear(c, c, bias=False) for _ in range(3))

    def forward(self, x, *, num_frames: int):
        bf, h, w, c = x.shape
        t = x.reshape(bf // num_frames, num_frames, h * w, c)
        o = temporal_attention(self.q(t), self.k(t), self.v(t), heads=self.heads, impl=self.impl)
        return (o + t).reshape(bf, h, w, c)


class FFOnly(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm, self.ff = LayerNorm(c), FeedForward(c, gelu_tanh=True)

    def forward(self, x, *, num_frames: int):
        return x + self.ff(self.norm(x))


def sites(model_config, size: int):
    """(side, channels) of the motion modules' levels: one per UNet block
    (the lowest also holds the mid block's)."""
    lat = size // model_config.vae.spatial_scale_factor
    return [(lat >> i, c) for i, c in enumerate(model_config.unet.block_out_channels)]


def variants(c: int, heads: int):
    return [
        ("full_motion_module", lambda: TemporalTransformer(c, heads, c // heads)),
        ("groupnorm_only", lambda: NormOnly(c)),
        ("proj_in_out_only", lambda: ProjOnly(c)),
        ("temporal_attn_k2", lambda: AttnOnly(c, heads, "auto")),
        ("temporal_attn_k6", lambda: AttnOnly(c, heads, "kernel")),
        ("temporal_attn_plain", lambda: AttnOnly(c, heads, "plain")),
        ("geglu_ff_only", lambda: FFOnly(c)),
    ]


def main(argv=None, model_config=None) -> int:
    """The command line; ``model_config`` (default: SD1.5) is for callers
    that profile another architecture from code."""
    from i2v_adapter_tpu_torch.config import I2VModelConfig
    from i2v_adapter_tpu_torch.models import AutoencoderKL
    from i2v_adapter_tpu_torch.models.vae import decode_sliced
    from i2v_adapter_tpu_torch.utils.random_init import randomize_

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=N_ITERS, help="calls per graph")
    ap.add_argument("--frames", type=int, default=F)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--decode-slices", default=",".join(map(str, DECODE_SLICES)),
                    help="decode_slice values of the VAE decode sweep ('' for none)")
    ap.add_argument("--device", default=None, help="default: the current CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model_config = model_config or I2VModelConfig()
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    heads = model_config.unet.motion_num_attention_heads
    g = torch.Generator(device=device).manual_seed(0)
    for side, c in sites(model_config, args.size):
        x = torch.randn(B * args.frames, side, side, c, generator=g, device=device).to(dtype)
        for seed, (name, make) in enumerate(variants(c, heads)):
            module = randomize_(make().to(device), seed).to(dtype).eval()
            out = {}

            def call():
                with torch.inference_mode():
                    out["y"] = module(x, num_frames=args.frames)

            ms, counts = graph_ms(call, device, args.iters)
            y = out.pop("y")
            emit("profile_motion", variant=name, side=side, channels=c, tokens=side * side, batch=B,
                 frames=args.frames, heads=heads, device=str(device), ms=ms, iters=args.iters,
                 launches_per_call=counts, finite=bool(torch.isfinite(y).all()))
            del module, y
    frames = args.frames
    slices = [int(s) for s in args.decode_slices.split(",") if s]
    if slices:
        vae = randomize_(AutoencoderKL(model_config.vae, device=device), 1).to(device, dtype).eval()
        lat = args.size // model_config.vae.spatial_scale_factor
        z = torch.randn(frames, lat, lat, model_config.vae.latent_channels, generator=g, device=device).to(dtype)
        for s in slices:
            if frames % s:
                continue
            out = {}

            def decode():
                with torch.inference_mode():
                    out["video"] = decode_sliced(vae.decode, z, s)

            ms = event_ms(decode, device, iters=1)
            emit("profile_motion", variant="vae_decode", decode_slice=s, frames=frames, size=args.size,
                 device=str(device), ms=ms, shape=list(out["video"].shape),
                 finite=bool(torch.isfinite(out.pop("video")).all()))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    print(card_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
