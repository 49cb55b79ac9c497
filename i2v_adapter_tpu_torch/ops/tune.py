"""Attention micro-benchmark: K1 against PyTorch's attention per UNet site.

Counterpart of the JAX package's ``ops/tune.py``: at the four SD1.5
spatial attention sites of a CFG-doubled 16-frame 512 px clip (``SITES``:
the self-attention and the I2V adapter's cross-frame attention, whose keys
are the first frame's, ``kv_repeat`` 16, at 64x64 and 32x32 latents), in
bf16, it times K1 (``flash_attention``) in both storage layouts -- (B, N,
H, D), as the projections give it, and (B, H, N, D), the reference's
row-major kernel (K5, ``transposed_io=False``) -- beside
``torch.nn.functional.scaled_dot_product_attention`` on the same storage
(keys expanded to the query batch once, outside the timed calls; the
yardstick, used nowhere else) and the port's plain version, with CUDA
events, and checks K1 against the plain version.  K1 and the plain version
take the UNet's softmax offset (``flash_static_max``, 64 at SD1.5), as the
serving sites run them; SDPA keeps the exact running max.  The JAX tool
sweeps the Pallas kernel's block sizes; K1's tiles are fixed at compile
time (``csrc/flash_attention.cu``), so the port's tool has no block sweep.

    python -m i2v_adapter_tpu_torch.ops.tune [--iters N] [--device cpu]

prints one JSON record per (site, layout): ms and TFLOP/s of K1, SDPA and
the plain version, K1's error against the plain version and the card's
bound; then the card's name and power limit.  On the CPU (``--device
cpu``) the sites are cut to 64 query and key tokens, K1's wrapper takes the
plain version and no time is reported.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from i2v_adapter_tpu_torch.device import resolve_device
from i2v_adapter_tpu_torch.ops.attention import _plain_attention, flash_attention
from i2v_adapter_tpu_torch.ops.profiling import card_line, emit, event_ms

# (name, Bq, Bkv, Nq, Nk, H, D): CFG-doubled 16-frame 512 px SD1.5 workload
SITES = [
    ("spat64 d40", 32, 32, 4096, 4096, 8, 40),
    ("xfrm64 d40", 32, 2, 4096, 4096, 8, 40),
    ("spat32 d80", 32, 32, 1024, 1024, 8, 80),
    ("xfrm32 d80", 32, 2, 1024, 1024, 8, 80),
]
LAYOUTS = ("bnhd", "bhnd")  # K1's default storage; the row-major (K5) one
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM data sheet, dense
TOL_BF16 = 2e-2  # of max |plain|: a bf16 output, p rounded to bf16


def run_site(name, bq, bkv, nq, nk, h, d, layout: str, device: torch.device, iters: int,
             static_max: float = 0.0) -> dict:
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    g = torch.Generator(device=device).manual_seed(nq * 31 + d + bkv)

    def operand(b, n):
        if layout == "bhnd":
            return torch.randn(b, h, n, d, generator=g, device=device).to(dtype).transpose(1, 2)
        return torch.randn(b, n, h, d, generator=g, device=device).to(dtype)

    q, k, v = operand(bq, nq), operand(bkv, nk), operand(bkv, nk)
    rep, scale = bq // bkv, 1.0 / math.sqrt(d)
    ke, ve = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
    k1 = lambda: flash_attention(q, k, v, kv_repeat=rep, scale=scale, static_max=static_max,  # noqa: E731
                                 transposed_io=layout == "bnhd")
    plain = lambda: _plain_attention(q, k, v, rep, scale, static_max)  # noqa: E731
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), ke.transpose(1, 2), ve.transpose(1, 2), scale=scale).transpose(1, 2)
    before = flash_attention.launches
    got, want = k1(), plain()
    launched = flash_attention.launches - before
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    flops = 4.0 * bq * h * nq * nk * d
    nbytes = 2.0 * h * d * (2 * bq * nq + 2 * bkv * nk)
    rates = {}
    for label, fn, n in (("k1", k1, iters), ("sdpa", sdpa, iters), ("plain", plain, 1)):
        ms = event_ms(fn, device, n)
        rates[f"{label}_ms"] = ms
        rates[f"{label}_tflops"] = None if ms is None else flops / (ms * 1e-3) / 1e12
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    return {"site": name, "layout": layout, "kernel": "K1" if layout == "bnhd" else "K5 (K1 on row-major storage)",
            "bq": bq, "bkv": bkv, "kv_repeat": rep, "nq": nq, "nk": nk, "heads": h, "d": d,
            "static_max": static_max,
            "dtype": str(dtype).replace("torch.", ""), **rates, "flops": flops,
            "bound_ms": bound if device.type == "cuda" else None,
            "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
            "rel_err": err, "ok": err <= (TOL_BF16 if dtype == torch.bfloat16 else 1e-5),
            "k1_launched": launched == (1 if device.type == "cuda" else 0)}


def main(argv=None, model_config=None) -> int:
    """The command line.  ``model_config`` (default: SD1.5) gives K1's
    softmax offset (``VideoUNetConfig.flash_static_max``, as the UNet's
    sites run it); the sites are SD1.5's."""
    from i2v_adapter_tpu_torch.config import I2VModelConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default=None, help="default: the current CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    static_max = (model_config or I2VModelConfig()).unet.flash_static_max
    ok = True
    for name, bq, bkv, nq, nk, h, d in SITES:
        if device.type != "cuda":
            bq, bkv, nq, nk = bq // 8, max(1, bkv // 8), 64, 64
        for layout in LAYOUTS:
            record = emit("tune", device=str(device), **run_site(name, bq, bkv, nq, nk, h, d, layout, device,
                                                                 args.iters, static_max))
            ok = ok and record["ok"] and record["k1_launched"]
    print(card_line(device), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
