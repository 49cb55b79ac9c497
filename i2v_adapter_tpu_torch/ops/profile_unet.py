"""UNet evaluation profiler: component costs by ablation.

Counterpart of the JAX package's ``ops/profile_unet.py``.  Each variant is
a video UNet at SD1.5 widths with seeded random bf16 weights, evaluated on
one CFG-doubled 512 px / 16-frame clip (batch 2), without the IP-Adapter
branch (as the JAX tool runs it) and with exact convs: N evaluations
captured into one CUDA graph and replayed between CUDA events, the
counterpart of the JAX tool's N evaluations in one jitted ``lax.scan``
(host launch cost stays out of the number).  The variants:

* ``full`` -- every part, attention through K1 and K2;
* ``no_motion_modules`` -- ``use_motion_modules=False``;
* ``no_i2v_adapter`` -- ``use_i2v_adapter=False``;
* ``unet_2d_only`` -- neither;
* ``convs_only`` -- neither, and no spatial transformers;

and two of the port's own:

* ``resnets_k4`` -- ``conv_impl='pallas'``: every resnet's GroupNorm-apply
  + SiLU + 3x3 conv stage through K4;
* ``attention_sdpa`` -- the ``full`` model with
  ``torch.nn.functional.scaled_dot_product_attention`` where it would
  launch K1 and K2 (the models' entry points swapped while it runs; exact
  softmax; the adapter's keys expanded per frame): PyTorch's own attention
  as a yardstick beside the kernels, used nowhere else.

    python -m i2v_adapter_tpu_torch.ops.profile_unet [--evals N] [--device cpu]

prints one JSON record per variant (ms per evaluation, the counted kernels'
launches per evaluation), then the card's name and power limit.  On the
CPU (``--device cpu``) each variant runs one plain evaluation and reports
no time.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import sys

import torch

from i2v_adapter_tpu_torch.device import resolve_device
from i2v_adapter_tpu_torch.ops import attention as A
from i2v_adapter_tpu_torch.ops.profiling import card_line, emit, graph_ms

N_EVALS = 8
FRAMES = 16
SIZE = 512


def variants(ucfg):
    """(name, UNet config, attention through SDPA) per variant, from the
    JAX tool's base: the IP branch off, exact convs."""
    base = ucfg.replace(use_ip_adapter=False, int8_conv=False)
    no_attn = (False,) * len(base.block_out_channels)
    two_d = base.replace(use_motion_modules=False, use_i2v_adapter=False)
    return [
        ("full", base, False),
        ("no_motion_modules", base.replace(use_motion_modules=False), False),
        ("no_i2v_adapter", base.replace(use_i2v_adapter=False), False),
        ("unet_2d_only", two_d, False),
        ("convs_only", two_d.replace(down_block_has_attention=no_attn, up_block_has_attention=no_attn), False),
        ("resnets_k4", base.replace(conv_impl="pallas"), False),
        ("attention_sdpa", base, True),
    ]


def _sdpa_dot_product(q, k, v, *, kv_repeat=1, scale=None, impl="auto", static_max=0.0):
    """``dot_product_attention`` with SDPA where it would launch K1, on the
    (B, N, H, D) views: k and v expanded to the query batch (clip-major,
    frame-minor), exact softmax."""
    if impl == "plain" or (impl == "auto" and k.shape[1] < 128):
        return A.xla_attention(q, k, v, kv_repeat=kv_repeat, scale=scale)
    k, v = (t.repeat_interleave(kv_repeat, 0) for t in (k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        scale=scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    return o.transpose(1, 2)


def _sdpa_temporal(q, k, v, *, heads: int, impl: str = "auto"):
    """``temporal_attention`` with SDPA where it would launch K2: (B, F, S,
    C) as (B, S, heads, F, d)."""
    if impl == "plain" or (impl == "auto" and q.shape[2] < 128):
        return A.temporal_attention_plain(q, k, v, heads)
    b, fq, s, c = q.shape
    f, d = k.shape[1], c // heads

    def split(t, frames):
        return t.reshape(b, frames, s, heads, d).permute(0, 2, 3, 1, 4)

    o = torch.nn.functional.scaled_dot_product_attention(split(q, fq), split(k, f), split(v, f))
    return o.permute(0, 3, 1, 2, 4).reshape(b, fq, s, c)


@contextlib.contextmanager
def sdpa_attention():
    """The models' attention entry points (``models.attention``'s
    ``dot_product_attention``, ``models.temporal``'s ``temporal_attention``)
    replaced by the SDPA ones while open; the kernels' wrappers and their
    counters are untouched."""
    from i2v_adapter_tpu_torch.models import attention as MA
    from i2v_adapter_tpu_torch.models import temporal as MT

    saved = MA.dot_product_attention, MT.temporal_attention
    MA.dot_product_attention, MT.temporal_attention = _sdpa_dot_product, _sdpa_temporal
    try:
        yield
    finally:
        MA.dot_product_attention, MT.temporal_attention = saved


def profile_variant(ucfg, device: torch.device, evals: int, frames: int, size: int, sdpa: bool = False,
                    latent_factor: int = 8, seed: int = 0) -> dict:
    """One variant's record: ms per evaluation over ``evals`` evaluations
    replayed from one CUDA graph, launches per evaluation, the output's
    shape and finiteness."""
    from i2v_adapter_tpu_torch.models import VideoUNet
    from i2v_adapter_tpu_torch.utils.random_init import randomize_

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    unet = randomize_(VideoUNet(ucfg, device=device), seed).to(device, dtype).eval()
    lat = size // latent_factor
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn(2, frames, lat, lat, ucfg.in_channels, generator=g, device=device).to(dtype)
    t = torch.full((2,), 501.0, device=device)
    text = torch.randn(2, 77, ucfg.cross_attention_dim, generator=g, device=device).to(dtype)
    out = {}

    def evaluate():
        with torch.inference_mode():
            out["y"] = unet(x, t, text, None, enable_cross_frame_attn=ucfg.use_i2v_adapter)

    with sdpa_attention() if sdpa else contextlib.nullcontext():
        ms, counts = graph_ms(evaluate, device, evals)
    y = out.pop("y")
    record = {"per_eval_ms": ms, "evals": evals, "launches_per_eval": counts, "shape": list(y.shape),
              "finite": bool(torch.isfinite(y).all())}
    del unet, out, y
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return record


def main(argv=None, model_config=None) -> int:
    """The command line; ``model_config`` (default: SD1.5) is for callers
    that profile another architecture from code."""
    from i2v_adapter_tpu_torch.config import I2VModelConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--evals", type=int, default=N_EVALS, help="evaluations per graph")
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--device", default=None, help="default: the current CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model_config = model_config or I2VModelConfig()
    for name, ucfg, sdpa in variants(model_config.unet):
        record = profile_variant(ucfg, device, args.evals, args.frames, args.size, sdpa,
                                 model_config.vae.spatial_scale_factor)
        emit("profile_unet", variant=name, device=str(device), frames=args.frames, size=args.size, batch=2,
             **record)
    print(card_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
