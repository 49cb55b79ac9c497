#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py              # needs one CUDA card and nvcc
    python3 chip_smoke.py --rehearse   # CPU rehearsal: tiny config, plain math

Phases, one JSON line each, in order:

1. ``device``   -- the card (nvidia-smi name and power limit), versions
2. ``build``    -- nvcc builds of the kernels in ``i2v_adapter_tpu_torch/csrc``
                   with the ptxas register / shared-memory report
3. ``kernels``  -- each kernel against its plain PyTorch version at every
                   shape the serving and training paths give it, in fp32
                   and bf16, with kernel / plain / library times and the
                   card's bound (K1 also with its logsumexp output)
4. ``unet``     -- one full-width (SD1.5) VideoUNet evaluation, kernels vs
                   plain attention, PSNR between the two
5. ``pipeline`` -- two image-to-video requests through I2VAdapterPipeline at
                   512x512, 16 frames, CFG 7.5, IP-Adapter, bf16, seeded
                   random weights; launch counts checked against the config
6. ``train``    -- the adapter training step at the reference workload
                   (``reference_train_config``: SD1.5 widths, 2 clips x 16
                   frames at 256 px, bf16 with
                   fp32 trainables, frozen weights in bf16, activation
                   checkpointing, AdamW), seeded random weights and a
                   synthetic batch: 1 warm-up + 4 timed steps; loss finite,
                   no step skipped, every trainable moved, no frozen weight
                   moved, K1/K2/K3 launches as derived from the config
7. ``gradcheck`` -- trainable gradients with the kernels vs with plain
                   attention over three seeds' draws (relative L2 error and
                   cosine over all trainables, worst leaf's relative L2),
                   and planted K3 faults that the limits must catch

Each path's launch counts are set to 0 just before it runs and read just
after.  Then the per-kernel summary ``{"kernels": [...]}``, the nvidia-smi
line and the result line ``{"ok": true, "device": {...}}``.  Any failure
raises and exits non-zero before the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

# card peaks (H100 SXM data sheet, dense): bf16 tensor cores, HBM
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# errors are max |kernel - plain| over max |plain| (no floor: attention
# outputs are well under 1, so a floor would turn these into loose absolutes)
TOL_FP32 = 1e-4  # fp32 sums in another order
TOL_BF16 = 2e-2  # bf16 output (one ulp is up to 2^-7 of max |plain|), p rounded
PSNR_MIN = 35.0
# kernel-vs-plain trainable gradients at full width, over the concatenated
# trainables and per leaf (the worst leaf): the two runs differ only by bf16
# rounding (p and ds' rounded in the kernels, the static softmax offset in
# K1, sums in another order).  Set from readings on an H100 over GRAD_SEEDS
# (all trainables: rel L2 3.0e-3 to 4.1e-3, 1 - cosine <= 8e-6; worst leaf,
# an adapter to_q: 1.9e-2 to 2.4e-2) at about 3x the largest, below what
# the planted K3 faults read: dq zeroed 0.060 / 1.8e-3 / 1.0 (worst leaf),
# dk zeroed 0.021 / 2.3e-4 / 0.047, fan-in cut 0.28 / 0.040 / 0.45.  Zeroed
# dk moves no single leaf far; the all-trainables limits catch it.
GRAD_REL_L2_MAX = 0.012
GRAD_LEAF_REL_L2_MAX = 0.08
GRAD_COSINE_MIN = 0.99995
GRAD_SEEDS = (0, 1, 2)
# faults planted in K3's results to show the check sees them: dq zeroed, dk
# zeroed, the kv_repeat fan-in of dk/dv cut to the first query frame
K3_FAULTS = ("dq_zero", "dk_zero", "fanin_one_frame")

TRAIN_STEPS = 4
KERNELS = ("flash_attention", "flash_attention_bwd", "temporal_attention_cs")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / float(b.abs().max())


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    peak = float(np.max(np.abs(b))) or 1.0
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(peak * peak / mse)


def device_ms(fn, iters: int) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# launch counts derived from the config
# ---------------------------------------------------------------------------


def launches_per_unet_eval(ucfg, latent: int, cross_frame: bool, flash_min: int = 128):
    """(flash, temporal) kernel launches of one VideoUNet evaluation under
    the 'auto' dispatch: flash for attention with >= 128 keys (attn1, and
    the adapter when cross-frame is on), temporal for motion modules with
    S >= 128 tokens (two attentions each).  ``flash_min`` counts only the
    flash sites with at least that many keys."""
    flash = temporal = 0
    n = ucfg.num_blocks
    per_block = ucfg.transformer_layers_per_block * (
        1 + (1 if ucfg.use_i2v_adapter and cross_frame else 0)
    )

    def site(tokens, layers, has_attn, motion):
        nonlocal flash, temporal
        if tokens >= max(128, flash_min) and has_attn:
            flash += layers * per_block
        if tokens >= 128 and motion:
            temporal += layers * 2

    for i in range(n):
        s = (latent >> i) ** 2
        site(s, ucfg.layers_per_block, ucfg.down_block_has_attention[i], ucfg.use_motion_modules)
    s_mid = (latent >> (n - 1)) ** 2
    site(s_mid, 1, True, ucfg.use_motion_modules and ucfg.use_motion_mid_block)
    for i in range(n):
        s = (latent >> (n - 1 - i)) ** 2
        site(s, ucfg.layers_per_block + 1, ucfg.up_block_has_attention[i], ucfg.use_motion_modules)
    return flash, temporal


def launches_per_train_step(ucfg, latent: int, tcfg, min_nk: int = 1024) -> dict:
    """Kernel launches of one train step: K1 and K2 at every site of the
    forward, again in the backward's recompute under activation
    checkpointing; K3 at every flash site with ``nk >= min_nk`` whose
    inputs carry a gradient.  In i2v mode the first transformer block's
    self-attention sees frozen weights only (nothing trainable runs before
    it unless motion modules train and precede it), so its backward is
    never taken."""
    cross_frame = tcfg.train_mode != "t2i"
    flash, temporal = launches_per_unet_eval(ucfg, latent, cross_frame)
    bwd = launches_per_unet_eval(ucfg, latent, cross_frame, flash_min=min_nk)[0]
    # the first attention level (the mid block's when no down block has one)
    first = next((i for i, a in enumerate(ucfg.down_block_has_attention) if a), ucfg.num_blocks - 1)
    motion_before = tcfg.update_motion_modules and ucfg.use_motion_modules and first > 0
    if tcfg.train_mode == "i2v" and not motion_before and (latent >> first) ** 2 >= min_nk:
        bwd -= 1
    recompute = 2 if tcfg.gradient_checkpointing else 1
    return {"flash_attention": recompute * flash, "flash_attention_bwd": bwd,
            "temporal_attention_cs": recompute * temporal}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(rehearse: bool) -> dict:
    info = {"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    if rehearse:
        info.update(name="cpu", nvidia_smi="not measured (rehearsal)")
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        info.update(name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
                    nvidia_smi=smi)
    emit(info)
    return info


def phase_build(rehearse: bool) -> None:
    from i2v_adapter_tpu_torch.ops import _build

    if rehearse:
        emit({"phase": "build", "skipped": "rehearsal: no nvcc on the CPU"})
        return
    t0 = time.perf_counter()
    report = _build.build()
    lines, kernel = [], "?"
    for r in report.values():
        for ln in r["ptxas"].splitlines():
            m = re.search(r"(flash_fwd_mma_kernel|flash_fwd_kernel|temporal_fwd_kernel|bwd_dq_mma_kernel"
                          r"|bwd_dkv_mma_kernel|bwd_dq_kernel|bwd_dkv_kernel)I(\w*?)EE", ln)
            if m:
                kernel = f"{m[1]}<{m[2].replace('13__nv_bfloat16', 'bf16')}>"
            elif "spill" in ln or "Used" in ln:
                lines.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: {"seconds": v["seconds"], "cached": v["cached"]} for k, v in report.items()},
          "ptxas": lines})


def _flash_case(name, bq, bkv, n, d, static_max, dev, iters, weight):
    """One K1 shape: kernel vs plain in fp32 and bf16, then bf16 timings."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops.attention import _plain_attention, flash_attention

    h = 8
    g = torch.Generator(device=dev).manual_seed(bq * 7919 + n * 31 + d)
    rep = bq // bkv
    scale = 1.0 / math.sqrt(d)
    # q as a strided view of a wider (fused-projection-like) buffer
    q32 = torch.randn(bq, n, 2 * h * d, generator=g, device=dev)[..., : h * d].unflatten(-1, (h, d))
    k32 = torch.randn(bkv, n, h, d, generator=g, device=dev)
    v32 = torch.randn(bkv, n, h, d, generator=g, device=dev)
    row = {"name": name, "bq": bq, "bkv": bkv, "kv_repeat": rep, "n": n, "d": d,
           "heads": h, "static_max": static_max, "launches_per_eval": weight}
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = (x.to(dt) for x in (q32, k32, v32))
        got, lse = flash_attention(q, k, v, kv_repeat=rep, scale=scale, static_max=static_max,
                                   with_lse=True)
        want, want_lse = _plain_attention(q, k, v, rep, scale, static_max, with_lse=True)
        row[f"rel_err_{tag}"] = rel_err(got, want)
        row[f"abs_err_{tag}"] = abs_err(got, want)
        row[f"finite_{tag}"] = bool(torch.isfinite(got).all())
        row[f"lse_rel_err_{tag}"] = rel_err(lse, want_lse)
    q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
    row["ms"] = device_ms(lambda: flash_attention(q, k, v, kv_repeat=rep, scale=scale,
                                                  static_max=static_max), iters)
    row["plain_ms"] = device_ms(lambda: _plain_attention(q, k, v, rep, scale, static_max), 2)
    ke, ve = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
    row["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), ke.transpose(1, 2), ve.transpose(1, 2), scale=scale), iters)
    flops = 4.0 * bq * h * n * n * d
    nbytes = 2.0 * h * d * (2 * bq * n + 2 * bkv * n)
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    ok = row["rel_err_fp32"] <= TOL_FP32 and row["rel_err_bf16"] <= TOL_BF16
    ok = ok and row["finite_fp32"] and row["finite_bf16"]
    # the logsumexp is fp32 from fp32 scores on both sides, whatever the input dtype
    ok = ok and max(row["lse_rel_err_fp32"], row["lse_rel_err_bf16"]) <= TOL_FP32
    return row, ok


def _flash_bwd_case(name, bq, bkv, n, d, dev, iters, weight):
    """One K3 shape: kernel vs plain in fp32 and bf16 from K1's own o and
    lse (static offset 64, as the training path runs it), then bf16 times:
    the kernel, its plain version and the backward of SDPA through
    autograd (the library yardstick, K/V repeated to the query batch)."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops.attention import (
        _plain_flash_backward,
        flash_attention,
        flash_attention_bwd,
    )

    h = 8
    g = torch.Generator(device=dev).manual_seed(bq * 7919 + n * 31 + d + 1)
    rep = bq // bkv
    scale = 1.0 / math.sqrt(d)
    q32 = torch.randn(bq, n, 2 * h * d, generator=g, device=dev)[..., : h * d].unflatten(-1, (h, d))
    k32 = torch.randn(bkv, n, h, d, generator=g, device=dev)
    v32 = torch.randn(bkv, n, h, d, generator=g, device=dev)
    g32 = torch.randn(bq, n, h, d, generator=g, device=dev)
    row = {"name": name, "bq": bq, "bkv": bkv, "kv_repeat": rep, "n": n, "d": d, "heads": h,
           "static_max": 64.0, "launches_per_step": weight}
    ok = True
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v, do = (x.to(dt) for x in (q32, k32, v32, g32))
        o, lse = flash_attention(q, k, v, kv_repeat=rep, scale=scale, static_max=64.0, with_lse=True)
        got = flash_attention_bwd(q, k, v, o, do, lse, kv_repeat=rep, scale=scale)
        want = _plain_flash_backward(q, k, v, o, do, lse, rep, scale)
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        row[f"rel_err_{tag}"] = max(errs)
        row[f"rel_err_{tag}_dq_dk_dv"] = errs
        row[f"abs_err_{tag}"] = max(abs_err(a, b) for a, b in zip(got, want))
        row[f"finite_{tag}"] = all(bool(torch.isfinite(a).all()) for a in got)
        ok = ok and row[f"finite_{tag}"] and row[f"rel_err_{tag}"] <= (
            TOL_FP32 if dt == torch.float32 else TOL_BF16)
    q, k, v, do = (x.to(torch.bfloat16) for x in (q32, k32, v32, g32))
    o, lse = flash_attention(q, k, v, kv_repeat=rep, scale=scale, static_max=64.0, with_lse=True)
    row["ms"] = device_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, kv_repeat=rep,
                                                      scale=scale), iters)
    row["plain_ms"] = device_ms(lambda: _plain_flash_backward(q, k, v, o, do, lse, rep, scale), 2)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)))
    out = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)
    gs = do.transpose(1, 2)
    row["library_ms"] = device_ms(
        lambda: torch.autograd.grad(out, (qs, ks, vs), gs, retain_graph=True), iters)
    # five products of 2*Nq*Nk*D per (query batch, head): S (recomputed
    # once), dP, dV, dQ, dK; the kernels' second S and dP in the dk/dv pass
    # are not counted
    flops = 10.0 * bq * h * n * n * d
    nbytes = 2.0 * h * d * n * (3 * bq + 2 * bkv) + 4.0 * bq * h * n + 2.0 * h * d * n * (bq + 2 * bkv)
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row, ok


def _temporal_case(name, b, fq, f, s, c, dev, iters, weight):
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops.attention import temporal_attention_cs, temporal_attention_plain

    heads = 8
    d = c // heads
    g = torch.Generator(device=dev).manual_seed(b * 104729 + s * 13 + c + f)
    q32 = torch.randn(b, fq, s, c, generator=g, device=dev)
    k32 = torch.randn(b, f, s, c, generator=g, device=dev)
    v32 = torch.randn(b, f, s, c, generator=g, device=dev)
    row = {"name": name, "b": b, "fq": fq, "f": f, "s": s, "c": c, "heads": heads,
           "launches_per_eval": weight}
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = (x.to(dt) for x in (q32, k32, v32))
        got = temporal_attention_cs(q, k, v, heads)
        want = temporal_attention_plain(q, k, v, heads)
        row[f"rel_err_{tag}"] = rel_err(got, want)
        row[f"abs_err_{tag}"] = abs_err(got, want)
    q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
    row["ms"] = device_ms(lambda: temporal_attention_cs(q, k, v, heads), iters)
    row["plain_ms"] = device_ms(lambda: temporal_attention_plain(q, k, v, heads), 3)
    to_sdpa = lambda x: x.unflatten(-1, (heads, d)).permute(0, 2, 3, 1, 4).reshape(-1, heads, x.shape[1], d)
    qs, ks, vs = to_sdpa(q), to_sdpa(k), to_sdpa(v)
    row["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), iters)
    flops = 4.0 * b * heads * fq * f * s * d
    nbytes = 2.0 * b * s * c * (2 * fq + 2 * f)
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    ok = row["rel_err_fp32"] <= TOL_FP32 and row["rel_err_bf16"] <= TOL_BF16
    return row, ok


def phase_kernels(dev, rehearse: bool):
    """Every serving shape at 512px / 16 frames / CFG (Bq = 32 frame-evals,
    8 heads), plus the edges the path could meet; every shape the 256 px
    training step gives K1 (with its logsumexp), K2 and K3, plus K3 at the
    512 px training shapes.  ``launches_per_eval`` weights a shape by how
    often one serving UNet evaluation launches it, ``launches_per_step`` by
    how often one training step does."""
    if rehearse:
        emit({"phase": "kernels", "skipped": "rehearsal: kernels need the card"})
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash_cases = [
        ("attn1 N4096 D40", 32, 32, 4096, 40, 64.0, 5),
        ("adapter N4096 D40", 32, 2, 4096, 40, 64.0, 5),
        ("attn1 N1024 D80", 32, 32, 1024, 80, 64.0, 5),
        ("adapter N1024 D80", 32, 2, 1024, 80, 64.0, 5),
        ("attn1 N256 D160", 32, 32, 256, 160, 64.0, 5),
        ("adapter N256 D160", 32, 2, 256, 160, 64.0, 5),
        ("adapter N4096 D40 exact-max", 32, 2, 4096, 40, 0.0, 0),
        ("ragged N577 D80 exact-max", 4, 4, 577, 80, 0.0, 0),
        ("ragged N577 D80 rep2 static", 4, 2, 577, 80, 64.0, 0),
        ("train attn1 N1024 D40", 32, 32, 1024, 40, 64.0, 0),
        ("train adapter N1024 D40", 32, 2, 1024, 40, 64.0, 0),
        ("train attn1 N256 D80", 32, 32, 256, 80, 64.0, 0),
        ("train adapter N256 D80", 32, 2, 256, 80, 64.0, 0),
    ]
    # (name, bq, bkv, n, d, launches per 256 px train step)
    bwd_cases = [
        ("train attn1 N1024 D40", 32, 32, 1024, 40, 4),
        ("train adapter N1024 D40", 32, 2, 1024, 40, 5),
        ("512px attn1 N4096 D40", 32, 32, 4096, 40, 0),
        ("512px adapter N4096 D40", 32, 2, 4096, 40, 0),
        ("512px attn1 N1024 D80", 32, 32, 1024, 80, 0),
        ("512px adapter N1024 D80", 32, 2, 1024, 80, 0),
        ("ragged N577 D80 rep16", 32, 2, 577, 80, 0),
    ]
    temporal_cases = [
        ("motion S4096 C320", 2, 16, 16, 4096, 320, 10),
        ("motion S1024 C640", 2, 16, 16, 1024, 640, 10),
        ("motion S256 C1280", 2, 16, 16, 256, 1280, 10),
        ("motion Fq8<F16 S1024 C640", 2, 8, 16, 1024, 640, 0),
        ("motion F32 S1024 C640", 2, 32, 32, 1024, 640, 0),
        ("motion S576 C1280", 2, 16, 16, 576, 1280, 0),
        ("motion F32 S256 C1280", 2, 32, 32, 256, 1280, 0),
        ("train motion S1024 C320", 2, 16, 16, 1024, 320, 0),
        ("train motion S256 C640", 2, 16, 16, 256, 640, 0),
    ]
    rows, failed = {name: [] for name in KERNELS}, []
    for case in flash_cases:
        row, ok = _flash_case(*case[:-1], dev=dev, iters=5, weight=case[-1])
        rows["flash_attention"].append(row)
        failed += [] if ok else [row["name"]]
    for case in bwd_cases:
        row, ok = _flash_bwd_case(*case[:-1], dev=dev, iters=5, weight=case[-1])
        rows["flash_attention_bwd"].append(row)
        failed += [] if ok else ["bwd " + row["name"]]
    for case in temporal_cases:
        row, ok = _temporal_case(*case[:-1], dev=dev, iters=20, weight=case[-1])
        rows["temporal_attention_cs"].append(row)
        failed += [] if ok else [row["name"]]
    emit({"phase": "kernels", "tol_fp32": TOL_FP32, "tol_bf16": TOL_BF16,
          "timing": "bf16, CUDA events, warm-up + mean of many launches, L2 not flushed",
          "cases": rows, "failed": failed})
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    return rows


def phase_unet(model_cfg, dev, dtype, rehearse: bool):
    """One full-width UNet evaluation (64x64 latents, 2 frames, CFG-doubled,
    cross-frame + IP) with the kernels and with plain attention."""
    from i2v_adapter_tpu_torch.models import VideoUNet
    from i2v_adapter_tpu_torch.ops.attention import launch_counts, reset_launch_counts
    from i2v_adapter_tpu_torch.utils.random_init import randomize_

    ucfg = model_cfg.unet
    unet = randomize_(VideoUNet(ucfg, device=dev), seed=1).to(dtype).eval()
    lat = 8 if rehearse else 64
    g = torch.Generator(device=dev).manual_seed(2)
    sample = torch.randn(2, 2, lat, lat, ucfg.in_channels, generator=g, device=dev)
    text = torch.randn(2, 77, ucfg.cross_attention_dim, generator=g, device=dev) * 0.5
    img = torch.randn(2, ucfg.image_embed_dim, generator=g, device=dev)
    run = lambda: unet(sample, 421.0, text, img, enable_cross_frame_attn=True).float()
    with torch.inference_mode():
        reset_launch_counts()
        t0 = time.perf_counter()
        got = run()
        if not rehearse:
            torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        counts = launch_counts()
        unet.set_attn_impl("plain")
        want = run()
        unet.set_attn_impl("auto")
    db = psnr(got.cpu().numpy(), want.cpu().numpy())
    expect = launches_per_unet_eval(ucfg, lat, True)
    line = {"phase": "unet", "latent": lat, "frames": 2, "batch": 2, "dtype": str(dtype),
            "psnr_db_kernel_vs_plain": db, "first_eval_s": kernel_s,
            "finite": bool(torch.isfinite(got).all()), "launches": counts,
            "expected_launches": {"flash_attention": expect[0], "flash_attention_bwd": 0,
                                  "temporal_attention_cs": expect[1]}}
    emit(line)
    if not line["finite"] or db <= PSNR_MIN:
        raise AssertionError(f"unet kernel vs plain: finite={line['finite']} psnr={db}")
    if not rehearse and counts != line["expected_launches"]:
        raise AssertionError(f"unet launches {counts} != expected {line['expected_launches']}")
    return unet


def phase_pipeline(model_cfg, unet, dev, dtype, rehearse: bool):
    from i2v_adapter_tpu_torch.config import PipelineConfig
    from i2v_adapter_tpu_torch.ops.attention import launch_counts, reset_launch_counts
    from i2v_adapter_tpu_torch.utils.random_init import random_pipeline

    size, frames, steps = (32, 2, 2) if rehearse else (512, 16, 5)
    pcfg = PipelineConfig(num_frames=frames, height=size, width=size, num_inference_steps=steps,
                          guidance_scale=7.5, blur_sigma=1.0, dtype="bfloat16" if not rehearse
                          else "float32", int8_conv=False)
    pipe = random_pipeline(model_cfg, pcfg, dev, unet=unet)
    image = np.random.default_rng(6).integers(0, 256, (size, size, 3), dtype=np.uint8)

    if not rehearse:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    requests = []
    for seed in (0, 1):
        t0 = time.perf_counter()
        video = pipe("a cat", condition_image=image, seed=seed)
        requests.append({"seed": seed, "seconds": time.perf_counter() - t0,
                         "shape": list(video.shape), "dtype": str(video.dtype),
                         "timings": pipe.last_timings, "video": video})
    counts = launch_counts()
    n_steps = len(pipe.last_timings["step_ms"])
    per_eval = launches_per_unet_eval(model_cfg.unet, size // model_cfg.vae.spatial_scale_factor, True)
    expected = {"flash_attention": 2 * n_steps * per_eval[0], "flash_attention_bwd": 0,
                "temporal_attention_cs": 2 * n_steps * per_eval[1]}
    if rehearse:
        expected = {k: 0 for k in expected}
    want_shape = [1, frames, size, size, 3]
    line = {
        "phase": "pipeline", "height": size, "width": size, "frames": frames,
        "num_inference_steps": steps, "denoise_steps": n_steps, "guidance_scale": 7.5,
        "requests": [{k: v for k, v in r.items() if k != "video"} for r in requests],
        "mean_step_ms": [float(np.mean(r["timings"]["step_ms"])) for r in requests],
        "peak_memory_gb": None if rehearse else torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "expected_launches": expected,
        "launches_per_unet_eval": {"flash_attention": per_eval[0], "temporal_attention_cs": per_eval[1]},
        "seeds_differ": bool(np.any(requests[0]["video"] != requests[1]["video"])),
    }
    emit(line)
    for r in requests:
        if r["shape"] != want_shape or r["dtype"] != "uint8":
            raise AssertionError(f"pipeline output {r['shape']} {r['dtype']} != {want_shape} uint8")
    if counts != expected:
        raise AssertionError(f"pipeline launches {counts} != expected {expected}")
    if not line["seeds_differ"]:
        raise AssertionError("two seeds gave the same clip")
    return counts


def phase_train(model_cfg, dev, rehearse: bool):
    """The reference training workload at full width (tiny in rehearsal):
    1 warm-up step, then ``TRAIN_STEPS`` synchronised steps with the launch
    counts set to 0 just before them and read just after."""
    from i2v_adapter_tpu_torch.config import reference_train_config
    from i2v_adapter_tpu_torch.ops.attention import launch_counts, reset_launch_counts
    from i2v_adapter_tpu_torch.training import make_train_step
    from i2v_adapter_tpu_torch.utils.random_init import random_train_batch, random_train_state

    tcfg = reference_train_config()
    if rehearse:
        tcfg = tcfg.replace(num_frames=2, resolution=32)
    if not rehearse:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = random_train_state(model_cfg, tcfg, dev, seed=1)
    batch = random_train_batch(model_cfg, tcfg, dev, seed=0)
    step_fn = make_train_step(model_cfg, tcfg, device=dev)
    setup_s = time.perf_counter() - t0

    def checksums():
        frozen = dict(state.unet.named_parameters())
        sums = [frozen[n].detach().float().sum() for n in state.frozen]
        for tower in (state.vae, state.text_encoder, state.image_encoder):
            sums += [p.detach().float().sum() for p in tower.parameters()]
        return torch.stack(sums)

    frozen_before = checksums()
    start = {n: p.detach().clone() for n, p in state.trainable_params().items()}
    sync = (lambda: None) if rehearse else torch.cuda.synchronize
    metrics, step_ms = [], []
    for i in range(1 + TRAIN_STEPS):
        if i == 1:
            reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = launch_counts()
    latent = tcfg.resolution // model_cfg.vae.spatial_scale_factor
    per_step = launches_per_train_step(model_cfg.unet, latent, tcfg)
    expected = {k: 0 if rehearse else TRAIN_STEPS * v for k, v in per_step.items()}
    moved = [n for n, p in state.trainable_params().items() if not torch.equal(p.detach(), start[n])]
    line = {
        "phase": "train", "config": tcfg.to_dict(), "setup_s": setup_s,
        "trainable_leaves": len(state.trainable), "frozen_leaves": len(state.frozen),
        "trainable_params": sum(start[n].numel() for n in start),
        "warmup_step_ms": step_ms[0], "step_ms": step_ms[1:],
        "mean_step_ms": float(np.mean(step_ms[1:])),
        "steps": metrics, "peak_memory_gb": None if rehearse else torch.cuda.max_memory_allocated() / 1e9,
        "trainables_moved": len(moved),
        "frozen_unchanged": bool(torch.equal(frozen_before, checksums())),
        "launches": counts, "expected_launches": expected, "launches_per_step": per_step,
    }
    emit(line)
    if not all(math.isfinite(m["loss"]) for m in metrics):
        raise AssertionError(f"train: non-finite loss {metrics}")
    if any(m["skipped_nonfinite"] for m in metrics):
        raise AssertionError(f"train: a step was skipped {metrics}")
    if len(moved) != len(start) or not line["frozen_unchanged"]:
        raise AssertionError(f"train: {len(moved)}/{len(start)} trainables moved, "
                             f"frozen unchanged={line['frozen_unchanged']}")
    if counts != expected:
        raise AssertionError(f"train launches {counts} != expected {expected}")
    return state, batch, step_fn, counts


def grad_errors(grads, ref) -> dict:
    """Relative L2 error and cosine over the concatenated gradients, and
    the worst leaf's relative L2 error."""
    gk = torch.cat([g.float().flatten() for g in grads.values()])
    gp = torch.cat([g.float().flatten() for g in ref.values()])
    leaf = {n: float((grads[n].float() - ref[n].float()).norm() / ref[n].float().norm())
            for n in ref}
    worst = max(leaf, key=leaf.get)
    return {"rel_l2": float((gk - gp).norm() / gp.norm()),
            "cosine": float(torch.nn.functional.cosine_similarity(gk, gp, dim=0)),
            "worst_leaf": worst, "worst_leaf_rel_l2": leaf[worst]}


def within_grad_limits(e: dict) -> bool:
    return (e["rel_l2"] <= GRAD_REL_L2_MAX and e["worst_leaf_rel_l2"] <= GRAD_LEAF_REL_L2_MAX
            and e["cosine"] >= GRAD_COSINE_MIN)


@contextlib.contextmanager
def planted_k3_fault(kind: str):
    """Swap K3's wrapper, as ``FlashAttentionFn`` calls it, for one whose
    result carries the fault ``kind`` (one of ``K3_FAULTS``)."""
    from i2v_adapter_tpu_torch.ops import attention

    real = attention.flash_attention_bwd

    def faulty(q, k, v, o, g, lse, *, kv_repeat=1, scale=None):
        dq, dk, dv = real(q, k, v, o, g, lse, kv_repeat=kv_repeat, scale=scale)
        if kind == "dq_zero":
            dq = torch.zeros_like(dq)
        elif kind == "dk_zero":
            dk = torch.zeros_like(dk)
        elif kind == "fanin_one_frame" and kv_repeat > 1:
            bq, nq, h = q.shape[:3]
            lse1 = lse.view(bq, h, nq)[::kv_repeat].reshape(-1, nq)
            _, dk, dv = real(q[::kv_repeat], k, v, o[::kv_repeat], g[::kv_repeat], lse1,
                             kv_repeat=1, scale=scale)
        return dq, dk, dv

    # the wrapper counts its launches on the module's name, here ``faulty``,
    # so the real count stays as the train phase left it
    faulty.launches = 0
    attention.flash_attention_bwd = faulty
    try:
        yield
    finally:
        attention.flash_attention_bwd = real


def phase_gradcheck(state, batch, step_fn, rehearse: bool):
    """Trainable gradients with the kernels vs with plain attention
    everywhere (autograd through the plain math), same draws, for each of
    ``GRAD_SEEDS``; then, on the card, each planted K3 fault against the
    first seed's plain gradients, which the limits must catch."""
    dev = next(state.unet.parameters()).device
    seeds, ref = [], None
    for seed in GRAD_SEEDS:
        draws = step_fn.draws(state, batch, torch.Generator(device=dev).manual_seed(seed))
        loss_k, grads_k = step_fn.loss_and_grads(state, batch, draws)
        state.unet.set_attn_impl("plain")
        try:
            loss_p, grads_p = step_fn.loss_and_grads(state, batch, draws)
        finally:
            state.unet.set_attn_impl("auto")
        if ref is None:
            ref = (draws, grads_p)
        seeds.append({"seed": seed, "loss_kernels": float(loss_k), "loss_plain": float(loss_p),
                      **grad_errors(grads_k, grads_p)})
    faults = {}
    for kind in () if rehearse else K3_FAULTS:
        with planted_k3_fault(kind):
            grads_f = step_fn.loss_and_grads(state, batch, ref[0])[1]
        faults[kind] = grad_errors(grads_f, ref[1])
    line = {"phase": "gradcheck", "seeds": seeds, "planted_k3_faults": faults
            if not rehearse else "skipped (rehearsal: no K3 site at the tiny config)",
            "rel_l2_max": GRAD_REL_L2_MAX, "leaf_rel_l2_max": GRAD_LEAF_REL_L2_MAX,
            "cosine_min": GRAD_COSINE_MIN}
    if rehearse:
        line["limits"] = "not applied (rehearsal: set for full width on the card)"
    emit(line)
    if rehearse:
        if not all(math.isfinite(s["rel_l2"]) for s in seeds):
            raise AssertionError(f"gradcheck: non-finite gradients {seeds}")
        return
    bad = [s["seed"] for s in seeds if not within_grad_limits(s)]
    if bad:
        raise AssertionError(f"gradcheck: seeds {bad} outside the limits: {seeds}")
    missed = [kind for kind, e in faults.items() if within_grad_limits(e)]
    if missed:
        raise AssertionError(f"gradcheck: planted K3 faults {missed} pass the limits: {faults}")


def summary(rows, paths, source_of) -> dict:
    """Per kernel: launches on the main paths (serving pipeline + training
    steps, each counted from 0) and the launch-weighted mean per launch over
    the main-path shapes (weights = launches per serving UNet evaluation
    for K1 and K2, per training step for K3)."""
    replaces = {
        "flash_attention": "i2v_adapter_tpu/ops/attention.py:143",
        "flash_attention_bwd": "i2v_adapter_tpu/ops/attention.py:518",
        "temporal_attention_cs": "i2v_adapter_tpu/ops/attention.py:985",
    }
    out = []
    for name, cases in rows.items():
        weight = lambda r: r.get("launches_per_eval", r.get("launches_per_step", 0))
        main = [r for r in cases if weight(r) > 0]
        w = sum(weight(r) for r in main)
        mean = lambda key: sum(r[key] * weight(r) for r in main) / w
        bytes_side = sum(weight(r) for r in main if r["bound_by"] == "bytes")
        out.append({
            "name": name, "route": "cuda", "source": source_of[name], "replaces": replaces[name],
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": max(max(r["abs_err_fp32"], r["abs_err_bf16"]) for r in cases),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": "bytes" if bytes_side * 2 > w else "operations",
            "library_ms": mean("library_ms"),
        })
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at the tiny config with plain math (no card)")
    args = ap.parse_args(argv)
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from i2v_adapter_tpu_torch.config import I2VModelConfig, tiny_test_config

    rehearse = args.rehearse
    dev = torch.device("cpu") if rehearse else torch.device("cuda", 0)
    dtype = torch.float32 if rehearse else torch.bfloat16
    model_cfg = tiny_test_config() if rehearse else I2VModelConfig()

    info = phase_device(rehearse)
    phase_build(rehearse)
    rows = phase_kernels(dev, rehearse)
    unet = phase_unet(model_cfg, dev, dtype, rehearse)
    counts = phase_pipeline(model_cfg, unet, dev, dtype, rehearse)
    del unet
    train_state, batch, step_fn, train_counts = phase_train(model_cfg, dev, rehearse)
    phase_gradcheck(train_state, batch, step_fn, rehearse)
    if rows is not None:
        emit(summary(rows, {"pipeline": counts, "train": train_counts}, {
            "flash_attention": "i2v_adapter_tpu_torch/csrc/flash_attention.cu",
            "flash_attention_bwd": "i2v_adapter_tpu_torch/csrc/flash_attention_bwd.cu",
            "temporal_attention_cs": "i2v_adapter_tpu_torch/csrc/temporal_attention.cu",
        }))
    print(info["nvidia_smi"], flush=True)
    if rehearse:
        emit({"ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 1}})
    else:
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
