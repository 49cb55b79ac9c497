#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py              # needs one CUDA card and nvcc
    python3 chip_smoke.py --rehearse   # CPU rehearsal: tiny config, plain math

Phases, one JSON line each, in order:

1. ``device``   -- the card (nvidia-smi name and power limit), versions
2. ``build``    -- nvcc builds of the kernels in ``i2v_adapter_tpu_torch/csrc``
                   with the ptxas register / shared-memory report; fails if
                   a wgmma kernel or K3's pre-pass spills
3. ``kernels``  -- each kernel against its plain PyTorch version at every
                   shape the serving and training paths give it, in fp32
                   and bf16, with kernel / plain / library times and the
                   card's bound (K1 also with its logsumexp output): the
                   attention kernels K1-K3, the fused GroupNorm-apply +
                   SiLU + 3x3 conv K4 at every resnet shape, K1 on
                   row-major storage (the reference's K5), K2 forced below
                   128 tokens (its K6) and the int8 matmul K7 (exact)
4. ``unet``     -- one full-width (SD1.5) VideoUNet evaluation, kernels vs
                   plain attention, PSNR between the two; the same weights
                   with ``conv_impl='pallas'`` (every resnet stage through
                   K4) against ``'auto'``; the temporal kernel forced at
                   every site against ``'auto'``
5. ``layouts``  -- ``flash_attention(transposed_io=False)`` on row-major
                   operands at the serving sites, against the default layout
6. ``pipeline`` -- two image-to-video requests through I2VAdapterPipeline at
                   512x512, 16 frames, CFG 7.5, IP-Adapter, bf16, seeded
                   random weights, and one more with ``conv_impl='pallas'``;
                   launch counts checked against the config
7. ``train``    -- the adapter training step at the reference workload
                   (``reference_train_config``: SD1.5 widths, 2 clips x 16
                   frames at 256 px, bf16 with
                   fp32 trainables, frozen weights in bf16, activation
                   checkpointing, AdamW), seeded random weights and a
                   synthetic batch: 1 warm-up + 4 timed steps; loss finite,
                   no step skipped, every trainable moved, no frozen weight
                   moved, K1/K2/K3 launches as derived from the config
8. ``gradcheck`` -- trainable gradients with the kernels vs with plain
                   attention over three seeds' draws (relative L2 error and
                   cosine over all trainables, worst leaf's relative L2),
                   and planted K3 faults that the limits must catch
9. ``train_pallas`` -- the same training workload with ``conv_impl='pallas'``:
                   1 warm-up + 2 timed steps, first-step loss within 2 % of
                   the ``'auto'`` run's on the same draws, K4 launched twice
                   per resnet conv per step (forward + recompute)
10. ``int8_tool`` -- ``ops.profile_int8_dense`` at a cut list of its shapes

Each path's launch counts are set to 0 just before it runs and read just
after.  Then the per-kernel summary ``{"kernels": [...]}``, the nvidia-smi
line and the result line ``{"ok": true, "device": {...}}``.  Any failure
raises and exits non-zero before the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

# card peaks (H100 SXM data sheet, dense): bf16 and int8 tensor cores, HBM
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
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
PALLAS_TRAIN_STEPS = 2
# first-step loss of the conv_impl='pallas' train run vs the 'auto' run's on
# the same weights and draws: the two differ by bf16 rounding of 44 convs
PALLAS_LOSS_REL_MAX = 0.02
# the counted kernel wrappers (K1, K3, K2, K4, K7)
KERNELS = ("flash_attention", "flash_attention_bwd", "temporal_attention_cs", "conv3x3_kernel",
           "int8_matmul")


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


def launch_counts() -> dict:
    """Launches of every counted kernel wrapper since the last reset."""
    from i2v_adapter_tpu_torch.ops import attention, conv3x3, profile_int8_dense

    return {**attention.launch_counts(), **conv3x3.launch_counts(),
            "int8_matmul": profile_int8_dense.int8_matmul.launches}


def reset_launch_counts() -> None:
    from i2v_adapter_tpu_torch.ops import attention, conv3x3, profile_int8_dense

    attention.reset_launch_counts()
    conv3x3.reset_launch_counts()
    profile_int8_dense.int8_matmul.launches = 0


def expected_counts(**counts) -> dict:
    return {name: counts.get(name, 0) for name in KERNELS}


# ---------------------------------------------------------------------------
# launch counts derived from the config
# ---------------------------------------------------------------------------


def launches_per_unet_eval(ucfg, latent: int, cross_frame: bool, flash_min: int = 128,
                           temporal_min: int = 128):
    """(flash, temporal) kernel launches of one VideoUNet evaluation under
    the 'auto' dispatch: flash for attention with >= 128 keys (attn1, and
    the adapter when cross-frame is on), temporal for motion modules with
    S >= 128 tokens (two attentions each).  ``flash_min`` counts only the
    flash sites with at least that many keys; ``temporal_min=0`` counts the
    temporal kernel forced at every motion module."""
    flash = temporal = 0
    n = ucfg.num_blocks
    per_block = ucfg.transformer_layers_per_block * (
        1 + (1 if ucfg.use_i2v_adapter and cross_frame else 0)
    )

    def site(tokens, layers, has_attn, motion):
        nonlocal flash, temporal
        if tokens >= max(128, flash_min) and has_attn:
            flash += layers * per_block
        if tokens >= temporal_min and motion:
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


def conv_sites(ucfg, latent: int):
    """``[(H, C, Cout, launches)]``: every distinct shape that one VideoUNet
    evaluation with ``conv_impl='pallas'`` gives K4 (two fused convs per
    resnet: C -> Cout and Cout -> Cout at the block's resolution H = W), with
    how often it is launched; empty under the other impls."""
    if ucfg.conv_impl != "pallas":
        return []
    sites, chans, n = {}, ucfg.block_out_channels, ucfg.num_blocks

    def resnet(h, cin, cout):
        for shape in ((h, cin, cout), (h, cout, cout)):
            sites[shape] = sites.get(shape, 0) + 1

    skips, cin = [chans[0]], chans[0]
    for i in range(n):
        for j in range(ucfg.layers_per_block):
            resnet(latent >> i, cin if j == 0 else chans[i], chans[i])
            skips.append(chans[i])
        if i < n - 1:
            skips.append(chans[i])
        cin = chans[i]
    for _ in range(2):
        resnet(latent >> (n - 1), chans[-1], chans[-1])
    x_ch = chans[-1]
    for i, out in enumerate(reversed(chans)):
        for j in range(ucfg.layers_per_block + 1):
            resnet(latent >> (n - 1 - i), (x_ch if j == 0 else out) + skips.pop(), out)
        x_ch = out
    return [(h, c, co, count) for (h, c, co), count in sites.items()]


def conv_launches_per_unet_eval(ucfg) -> int:
    """K4 launches of one VideoUNet evaluation (the resolution does not
    change the count)."""
    return sum(count for *_, count in conv_sites(ucfg, 64))


def launches_per_train_step(ucfg, latent: int, tcfg, min_nk: int = 1024) -> dict:
    """Kernel launches of one train step: K1 and K2 at every site of the
    forward, again in the backward's recompute under activation
    checkpointing; K3 at every flash site with ``nk >= min_nk`` whose
    inputs carry a gradient; K4 twice per resnet conv under
    ``conv_impl='pallas'`` (its backward is plain).  In i2v mode the first transformer block's
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
            "temporal_attention_cs": recompute * temporal,
            "conv3x3_kernel": recompute * conv_launches_per_unet_eval(ucfg)}


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


# kernels whose ptxas report must show no spills (the wgmma kernels and the
# backward's pre-pass)
NO_SPILL = re.compile(r"wgmma_kernel|bwd_prep_kernel")


def phase_build(rehearse: bool) -> None:
    """nvcc builds of every source, with each kernel's registers and spills
    from ptxas; fails if a kernel in ``NO_SPILL`` spills.  ptxas notes that
    it injected a wgmma wait or fence (which serialises the pipelined loops)
    are counted per kernel."""
    from i2v_adapter_tpu_torch.ops import _build

    if rehearse:
        emit({"phase": "build", "skipped": "rehearsal: no nvcc on the CPU"})
        return
    t0 = time.perf_counter()
    report = _build.build()
    lines, spills, injected, kernel = [], [], {}, "?"
    name = re.compile(r"(flash_fwd_wgmma_kernel|flash_fwd_kernel|temporal_fwd_kernel|bwd_dq_wgmma_kernel"
                      r"|bwd_dkv_wgmma_kernel|bwd_dq_mma_kernel|bwd_dkv_mma_kernel|bwd_dq_kernel"
                      r"|bwd_dkv_kernel|bwd_prep_kernel|conv3x3_mma_kernel|conv3x3_f32_kernel)I(\w*?)EE")
    for r in report.values():
        for ln in r["ptxas"].splitlines():
            m = name.search(ln)
            if "injected" in ln and m:
                key = f"{m[1]}<{m[2]}>"
                injected[key] = injected.get(key, 0) + 1
            elif m:
                kernel = f"{m[1]}<{m[2].replace('13__nv_bfloat16', 'bf16')}>"
            elif "int8_mm_kernel" in ln:
                kernel = "int8_mm_kernel"
            elif "spill" in ln or "Used" in ln:
                lines.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
                counts = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
                if NO_SPILL.search(kernel) and any(int(c) for c in counts):
                    spills.append(f"{kernel}: {ln.strip()}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: {"seconds": v["seconds"], "cached": v["cached"]} for k, v in report.items()},
          "ptxas": lines, "spills": spills, "wgmma_sync_injected": injected})
    if spills:
        raise AssertionError(f"build: kernels that must not spill do: {spills}")


def _flash_case(name, bq, bkv, n, d, static_max, dev, iters, weight, row_major=False):
    """One K1 shape: kernel vs plain in fp32 and bf16, then bf16 timings.
    ``row_major`` stores q, k, v as (B, H, N, D) and calls the
    ``transposed_io=False`` entry (the reference's row-major kernel, K5)."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops.attention import _plain_attention, flash_attention

    h = 8
    g = torch.Generator(device=dev).manual_seed(bq * 7919 + n * 31 + d)
    rep = bq // bkv
    scale = 1.0 / math.sqrt(d)
    if row_major:
        q32, k32, v32 = (torch.randn(b, h, n, d, generator=g, device=dev).transpose(1, 2)
                         for b in (bq, bkv, bkv))
    else:
        # q as a strided view of a wider (fused-projection-like) buffer
        q32 = torch.randn(bq, n, 2 * h * d, generator=g, device=dev)[..., : h * d].unflatten(-1, (h, d))
        k32 = torch.randn(bkv, n, h, d, generator=g, device=dev)
        v32 = torch.randn(bkv, n, h, d, generator=g, device=dev)
    row = {"name": name, "bq": bq, "bkv": bkv, "kv_repeat": rep, "n": n, "d": d,
           "heads": h, "static_max": static_max, "launches_per_eval": weight,
           "storage": "(B,H,N,D)" if row_major else "(B,N,H,D)"}
    flash_attention = functools.partial(flash_attention, transposed_io=not row_major)
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = (x.to(dt) for x in (q32, k32, v32))
        if row_major:  # the cast keeps the strides; the entry must then copy nothing
            assert q.transpose(1, 2).is_contiguous() and k.transpose(1, 2).is_contiguous()
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


def _temporal_case(name, b, fq, f, s, c, dev, iters, weight, forced=False):
    """One K2 shape.  ``forced`` goes through ``temporal_attention(impl=
    "kernel")``, the dispatcher with the kernel forced (the reference's
    all-of-C kernel K6, which its forced impl also runs below 128 tokens)."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops.attention import (
        temporal_attention,
        temporal_attention_cs,
        temporal_attention_plain,
    )

    if forced:
        temporal_attention_cs = lambda q, k, v, heads: temporal_attention(  # noqa: E731
            q, k, v, heads=heads, impl="kernel")

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


def _conv_case(name, b, h, w, c, co, dev, iters, weight=0, step_weight=0, fused=True,
               fp32=False, bf16=True):
    """One K4 shape: kernel vs plain (fp32 with TF32 off, and/or bf16), then
    bf16 timings: the kernel, its plain version, the fold of the GroupNorm
    statistics that precedes it in the model (plain PyTorch, not part of
    K4), and the library's GroupNorm -> SiLU -> conv and conv alone on
    channels-last tensors.  Weights in the model's OIHW storage."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops import conv3x3 as C
    from i2v_adapter_tpu_torch.ops.norms import fold_gn_affine

    groups, eps = (32 if c % 32 == 0 else 8), 1e-5
    g = torch.Generator(device=dev).manual_seed(b * 131 + h * 17 + w + c * 3 + co)
    x32 = torch.randn(b, h, w, c, generator=g, device=dev) * 2 + 0.5
    w32 = torch.randn(co, c, 3, 3, generator=g, device=dev) / math.sqrt(9 * c)
    bias32 = torch.randn(co, generator=g, device=dev) * 0.1
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    row = {"name": name, "b": b, "h": h, "w": w, "c": c, "cout": co, "fused": fused,
           "launches_per_eval": weight, "launches_per_step": step_weight}
    ok = True
    for tag, dt, on in (("fp32", torch.float32, fp32), ("bf16", torch.bfloat16, bf16)):
        if not on:
            continue
        x, kernel, bias = x32.to(dt), w32.to(dt).permute(2, 3, 1, 0), bias32.to(dt)
        pre = fold_gn_affine(x, groups, eps, gamma, beta) if fused else (None, None)
        got = C.conv3x3_kernel(x, kernel, bias, *pre)
        want = (C.gn_silu_conv3x3_plain(x, *pre, kernel, bias) if fused
                else C.conv3x3_plain(x, kernel, bias))
        row[f"rel_err_{tag}"] = rel_err(got, want)
        row[f"abs_err_{tag}"] = abs_err(got, want)
        row[f"finite_{tag}"] = bool(torch.isfinite(got).all())
        ok = ok and row[f"finite_{tag}"] and row[f"rel_err_{tag}"] <= (
            TOL_FP32 if dt == torch.float32 else TOL_BF16)
    if bf16:
        x, wb, bias = x32.to(torch.bfloat16), w32.to(torch.bfloat16), bias32.to(torch.bfloat16)
        kernel = wb.permute(2, 3, 1, 0)
        pre = fold_gn_affine(x, groups, eps, gamma, beta) if fused else (None, None)
        row["ms"] = device_ms(lambda: C.conv3x3_kernel(x, kernel, bias, *pre), iters)
        xn = x.permute(0, 3, 1, 2)  # NCHW view of channel-last storage
        gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
        if fused:
            row["plain_ms"] = device_ms(lambda: C.gn_silu_conv3x3_plain(x, *pre, kernel, bias), 3)
            row["fold_ms"] = device_ms(lambda: fold_gn_affine(x, groups, eps, gamma, beta), iters)
            row["library_ms"] = device_ms(lambda: F.conv2d(
                F.silu(F.group_norm(xn, groups, gb, bb, eps)), wb, bias, padding=1), iters)
            act = F.silu(F.group_norm(xn, groups, gb, bb, eps))
            row["library_conv_ms"] = device_ms(lambda: F.conv2d(act, wb, bias, padding=1), iters)
        else:
            row["plain_ms"] = device_ms(lambda: C.conv3x3_plain(x, kernel, bias), 3)
            row["library_ms"] = device_ms(lambda: F.conv2d(xn, wb, bias, padding=1), iters)
        flops = 2.0 * b * h * w * 9 * c * co
        nbytes = 2.0 * (b * h * w * (c + co) + 9 * c * co + co) + (8.0 * b * c if fused else 0.0)
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        row["bound_share"] = row["bound_ms"] / row["ms"]
    return row, ok


def _int8_case(name, m, k, n, dev, iters, weight):
    """One K7 shape: the int32 result equal to the exact product (a float64
    matmul holds these sums exactly), then times: the kernel, that plain
    version and ``torch._int_mm`` (the library yardstick; it needs M > 16 and
    K, N multiples of 8, else null)."""
    from i2v_adapter_tpu_torch.ops.profile_int8_dense import int8_matmul, int8_matmul_plain

    g = torch.Generator(device=dev).manual_seed(m + 7 * k + 13 * n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    got, want = int8_matmul(xq, wq), int8_matmul_plain(xq, wq)
    diff = float((got.double() - want.double()).abs().max())
    row = {"name": name, "m": m, "k": k, "n": n, "launches_per_tool_run": weight,
           "abs_err_int32": diff, "equal": bool(torch.equal(got, want))}
    row["ms"] = device_ms(lambda: int8_matmul(xq, wq), iters)
    row["plain_ms"] = device_ms(lambda: int8_matmul_plain(xq, wq), 2)
    row["library_ms"] = (device_ms(lambda: torch._int_mm(xq, wq), iters)
                         if m > 16 and k % 8 == 0 and n % 8 == 0 else None)
    row["bound_ms"], row["bound_by"] = bound_ms(2.0 * m * k * n, m * k + k * n + 4.0 * m * n,
                                                PEAK_INT8_OPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row, row["equal"]


# the tool's shapes that the smoke run times (one per UNet level)
INT8_TOOL_SHAPES = (0, 6, 12)


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
    # K1 on (B, H, N, D) storage (the reference's K5) at the serving sites
    row_major_cases = [c for c in flash_cases if c[-1] > 0]
    # K2 forced below 128 tokens (the reference's K6): the 8x8 level, where
    # 'auto' takes the einsum; 12 launches per evaluation when forced
    forced_cases = [
        ("forced S64 C1280", 2, 16, 16, 64, 1280, 12),
        ("forced Fq8<F16 S64 C1280", 2, 8, 16, 64, 1280, 0),
    ]
    from i2v_adapter_tpu_torch.config import VideoUNetConfig
    from i2v_adapter_tpu_torch.ops.profile_int8_dense import SHAPES as INT8_SHAPES

    fused_cfg = VideoUNetConfig(conv_impl="pallas")
    train_sites = {(h, c, co): 2 * cnt for h, c, co, cnt in conv_sites(fused_cfg, 32)}
    rows, failed = {name: [] for name in KERNELS}, []
    rows["flash_attention_row_major"], rows["temporal_attention_forced"] = [], []

    def add(key, result, prefix=""):
        rows[key].append(result[0])
        if not result[1]:
            failed.append(prefix + result[0]["name"])

    # K4: every shape of the 512 px serving evaluation (B = 32 frame-evals),
    # then the 256 px training step's shapes that serving lacks
    for h, c, co, cnt in conv_sites(fused_cfg, 64):
        add("conv3x3_kernel", _conv_case(f"H{h} {c}->{co}", 32, h, h, c, co, dev, 5, weight=cnt,
                                         step_weight=train_sites.pop((h, c, co), 0)))
    for (h, c, co), cnt in train_sites.items():
        add("conv3x3_kernel", _conv_case(f"train H{h} {c}->{co}", 32, h, h, c, co, dev, 5,
                                         step_weight=cnt))
    add("conv3x3_kernel", _conv_case("unfused H32 640->640", 32, 32, 32, 640, 640, dev, 5,
                                     fused=False, fp32=False))
    add("conv3x3_kernel", _conv_case("unfused fp32 H16 320->640", 2, 16, 16, 320, 640, dev, 5,
                                     fused=False, fp32=True, bf16=False))
    add("conv3x3_kernel", _conv_case("fp32 B4 H64 320->320", 4, 64, 64, 320, 320, dev, 5,
                                     fp32=True, bf16=False))
    add("conv3x3_kernel", _conv_case("fp32 B4 H8 2560->1280", 4, 8, 8, 2560, 1280, dev, 5,
                                     fp32=True, bf16=False))
    add("conv3x3_kernel", _conv_case("ragged 12x8 136->264", 2, 12, 8, 136, 264, dev, 5, fp32=True))
    for i, (m, k, n) in enumerate(INT8_SHAPES):
        add("int8_matmul", _int8_case(f"{m}x{k}x{n}", m, k, n, dev, 5,
                                      weight=int(i in INT8_TOOL_SHAPES)), "int8 ")
    add("int8_matmul", _int8_case("ragged 1000x48x36", 1000, 48, 36, dev, 5, weight=0), "int8 ")
    for case in row_major_cases:
        add("flash_attention_row_major",
            _flash_case(*case[:-1], dev=dev, iters=5, weight=case[-1], row_major=True), "row-major ")
    for case in forced_cases:
        add("temporal_attention_forced",
            _temporal_case(*case[:-1], dev=dev, iters=20, weight=case[-1], forced=True))
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
    cross-frame + IP) with the kernels and with plain attention; then the
    same weights in a model built with ``conv_impl='pallas'`` (every resnet
    stage through K4) and with the temporal kernel forced at every motion
    module, each against the ``'auto'`` result."""
    from i2v_adapter_tpu_torch.models import VideoUNet
    from i2v_adapter_tpu_torch.models.temporal import TemporalSelfAttention
    from i2v_adapter_tpu_torch.utils.random_init import randomize_

    ucfg = model_cfg.unet
    unet = randomize_(VideoUNet(ucfg, device=dev), seed=1).to(dtype).eval()
    fused_cfg = ucfg.replace(conv_impl="pallas")
    fused = VideoUNet(fused_cfg, device=dev).to(dtype).eval()
    fused.load_state_dict(unet.state_dict())
    lat = 8 if rehearse else 64
    g = torch.Generator(device=dev).manual_seed(2)
    sample = torch.randn(2, 2, lat, lat, ucfg.in_channels, generator=g, device=dev)
    text = torch.randn(2, 77, ucfg.cross_attention_dim, generator=g, device=dev) * 0.5
    img = torch.randn(2, ucfg.image_embed_dim, generator=g, device=dev)
    run = lambda m: m(sample, 421.0, text, img, enable_cross_frame_attn=True).float()
    sync = (lambda: None) if rehearse else torch.cuda.synchronize

    def counted(m):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run(m)
        sync()
        return out, time.perf_counter() - t0, launch_counts()

    with torch.inference_mode():
        got, kernel_s, counts = counted(unet)
        unet.set_attn_impl("plain")
        want = run(unet)
        unet.set_attn_impl("auto")
        got_fused, fused_s, fused_counts = counted(fused)
        temporal = [m for m in unet.modules() if isinstance(m, TemporalSelfAttention)]
        for m in temporal:
            m.attn_impl = "kernel"
        got_forced, _, forced_counts = counted(unet)
        for m in temporal:
            m.attn_impl = "auto"
    db = psnr(got.cpu().numpy(), want.cpu().numpy())
    db_fused = psnr(got_fused.cpu().numpy(), got.cpu().numpy())
    db_forced = psnr(got_forced.cpu().numpy(), got.cpu().numpy())
    flash, temporal_auto = launches_per_unet_eval(ucfg, lat, True)
    temporal_all = launches_per_unet_eval(ucfg, lat, True, temporal_min=0)[1]
    expected = expected_counts(flash_attention=flash, temporal_attention_cs=temporal_auto)
    expected_fused = dict(expected, conv3x3_kernel=conv_launches_per_unet_eval(fused_cfg))
    expected_forced = dict(expected, temporal_attention_cs=temporal_all)
    if rehearse:
        expected = expected_fused = expected_forced = expected_counts()
    finite = all(bool(torch.isfinite(t).all()) for t in (got, got_fused, got_forced))
    line = {"phase": "unet", "latent": lat, "frames": 2, "batch": 2, "dtype": str(dtype),
            "psnr_db_kernel_vs_plain": db, "first_eval_s": kernel_s, "finite": finite,
            "launches": counts, "expected_launches": expected,
            "conv_impl_pallas": {"psnr_db_vs_auto": db_fused, "first_eval_s": fused_s,
                                 "launches": fused_counts, "expected_launches": expected_fused},
            "temporal_kernel_forced": {"psnr_db_vs_auto": db_forced, "launches": forced_counts,
                                       "expected_launches": expected_forced}}
    emit(line)
    if not finite or min(db, db_fused, db_forced) <= PSNR_MIN:
        raise AssertionError(f"unet: finite={finite} psnr kernel vs plain {db}, "
                             f"conv_impl pallas vs auto {db_fused}, forced temporal vs auto {db_forced}")
    for name, have, want_counts in (("auto", counts, expected), ("pallas", fused_counts, expected_fused),
                                    ("forced temporal", forced_counts, expected_forced)):
        if have != want_counts:
            raise AssertionError(f"unet ({name}) launches {have} != expected {want_counts}")
    return unet, fused, forced_counts


def phase_layouts(dev, rehearse: bool):
    """K1 on row-major operands through the entry a caller would use:
    ``flash_attention(transposed_io=False)`` on q, k, v stored (B, H, N, D),
    at the serving sites in bf16 (a small shape on the CPU), against the
    same call on the default layout; the two read the same numbers through
    other strides, so they agree exactly."""
    from i2v_adapter_tpu_torch.ops.attention import flash_attention

    sites = [(4, 2, 160, 8)] if rehearse else [(32, 32, 4096, 40), (32, 2, 4096, 40),
                                               (32, 32, 1024, 80), (32, 2, 1024, 80),
                                               (32, 32, 256, 160), (32, 2, 256, 160)]
    dt = torch.float32 if rehearse else torch.bfloat16
    cases = []
    for i, (bq, bkv, n, d) in enumerate(sites):
        g = torch.Generator(device=dev).manual_seed(40 + i)
        q, k, v = (torch.randn(b, n, 8, d, generator=g, device=dev).to(dt) for b in (bq, bkv, bkv))
        want = flash_attention(q, k, v, kv_repeat=bq // bkv, static_max=64.0)
        # row-major copies of the operands: (B, H, N, D) storage, (B, N, H, D) views
        cases.append((*(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)),
                      bq // bkv, want))
    reset_launch_counts()
    worst = 0.0
    for qr, kr, vr, rep, want in cases:
        got = flash_attention(qr, kr, vr, kv_repeat=rep, static_max=64.0, transposed_io=False)
        if not rehearse and not got.transpose(1, 2).is_contiguous():
            raise AssertionError("row-major entry returned another layout")
        worst = max(worst, abs_err(got, want))
    counts = launch_counts()
    expected = expected_counts(flash_attention=0 if rehearse else len(sites))
    emit({"phase": "layouts", "sites": sites, "dtype": str(dt), "max_abs_diff_vs_default_layout": worst,
          "launches": counts, "expected_launches": expected})
    # on the card one kernel does the same arithmetic through other strides
    if worst > (1e-5 if rehearse else 0.0) or counts != expected:
        raise AssertionError(f"layouts: diff {worst}, launches {counts} != {expected}")
    return counts


def phase_pipeline(model_cfg, unet, fused_unet, dev, dtype, rehearse: bool):
    """Two requests with the ``'auto'`` UNet, then one with the same weights
    in the ``conv_impl='pallas'`` UNet (the other models shared), each
    path's launch counts set to 0 just before it and read just after."""
    from i2v_adapter_tpu_torch.config import PipelineConfig
    from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
    from i2v_adapter_tpu_torch.utils.random_init import random_pipeline

    size, frames, steps = (32, 2, 2) if rehearse else (512, 16, 5)
    pcfg = PipelineConfig(num_frames=frames, height=size, width=size, num_inference_steps=steps,
                          guidance_scale=7.5, blur_sigma=1.0, dtype="bfloat16" if not rehearse
                          else "float32", int8_conv=False)
    pipe = random_pipeline(model_cfg, pcfg, dev, unet=unet)
    fused_cfg = model_cfg.replace(unet=fused_unet.config)
    fused_pipe = I2VAdapterPipeline(
        fused_cfg, {"unet": fused_unet, "vae": pipe.vae, "text_encoder": pipe.text_encoder,
                    "image_encoder": pipe.image_encoder}, pipe.tokenizer, pcfg, device=dev)
    image = np.random.default_rng(6).integers(0, 256, (size, size, 3), dtype=np.uint8)
    latent = size // model_cfg.vae.spatial_scale_factor
    per_eval = launches_per_unet_eval(model_cfg.unet, latent, True)
    conv_per_eval = conv_launches_per_unet_eval(fused_cfg.unet)

    def serve(p, seeds):
        reset_launch_counts()
        requests = []
        for seed in seeds:
            t0 = time.perf_counter()
            video = p("a cat", condition_image=image, seed=seed)
            requests.append({"seed": seed, "seconds": time.perf_counter() - t0,
                             "shape": list(video.shape), "dtype": str(video.dtype),
                             "timings": p.last_timings, "video": video})
        counts = launch_counts()
        evals = sum(len(r["timings"]["step_ms"]) for r in requests)
        expected = expected_counts(
            flash_attention=evals * per_eval[0], temporal_attention_cs=evals * per_eval[1],
            conv3x3_kernel=evals * conv_launches_per_unet_eval(p.config.unet))
        if rehearse:
            expected = expected_counts()
        return requests, counts, expected

    if not rehearse:
        torch.cuda.reset_peak_memory_stats()
    requests, counts, expected = serve(pipe, (0, 1))
    fused_requests, fused_counts, fused_expected = serve(fused_pipe, (0,))
    n_steps = len(pipe.last_timings["step_ms"])
    want_shape = [1, frames, size, size, 3]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "video"} for r in rs]
    line = {
        "phase": "pipeline", "height": size, "width": size, "frames": frames,
        "num_inference_steps": steps, "denoise_steps": n_steps, "guidance_scale": 7.5,
        "requests": strip(requests),
        "mean_step_ms": [float(np.mean(r["timings"]["step_ms"])) for r in requests],
        "peak_memory_gb": None if rehearse else torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "expected_launches": expected,
        "launches_per_unet_eval": {"flash_attention": per_eval[0], "temporal_attention_cs": per_eval[1]},
        "seeds_differ": bool(np.any(requests[0]["video"] != requests[1]["video"])),
        "conv_impl_pallas": {
            "requests": strip(fused_requests),
            "mean_step_ms": float(np.mean(fused_requests[0]["timings"]["step_ms"])),
            # seed 0 under both impls: same weights and draws, bf16 rounding apart
            "psnr_db_vs_auto": psnr(fused_requests[0]["video"], requests[0]["video"]),
            "launches": fused_counts, "expected_launches": fused_expected,
            "conv_launches_per_unet_eval": conv_per_eval,
        },
    }
    emit(line)
    for r in requests + fused_requests:
        if r["shape"] != want_shape or r["dtype"] != "uint8":
            raise AssertionError(f"pipeline output {r['shape']} {r['dtype']} != {want_shape} uint8")
    if counts != expected or fused_counts != fused_expected:
        raise AssertionError(f"pipeline launches {counts} != expected {expected}, or with "
                             f"conv_impl='pallas' {fused_counts} != {fused_expected}")
    if not line["seeds_differ"]:
        raise AssertionError("two seeds gave the same clip")
    return counts, fused_counts


def phase_train(model_cfg, dev, rehearse: bool, steps: int = TRAIN_STEPS, phase: str = "train",
                first_loss=None):
    """The reference training workload at full width (tiny in rehearsal):
    1 warm-up step, then ``steps`` synchronised steps with the launch
    counts set to 0 just before them and read just after.  ``first_loss``
    is another run's first-step loss on the same seeds (the same weights
    and draws) that this run's must match within ``PALLAS_LOSS_REL_MAX``."""
    from i2v_adapter_tpu_torch.config import reference_train_config
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
    for i in range(1 + steps):
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
    expected = expected_counts(**{k: 0 if rehearse else steps * v for k, v in per_step.items()})
    moved = [n for n, p in state.trainable_params().items() if not torch.equal(p.detach(), start[n])]
    line = {
        "phase": phase, "conv_impl": model_cfg.unet.conv_impl, "config": tcfg.to_dict(),
        "setup_s": setup_s,
        "trainable_leaves": len(state.trainable), "frozen_leaves": len(state.frozen),
        "trainable_params": sum(start[n].numel() for n in start),
        "warmup_step_ms": step_ms[0], "step_ms": step_ms[1:],
        "mean_step_ms": float(np.mean(step_ms[1:])),
        "steps": metrics, "peak_memory_gb": None if rehearse else torch.cuda.max_memory_allocated() / 1e9,
        "first_loss_reference": first_loss, "trainables_moved": len(moved),
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
    if first_loss is not None:
        rel = abs(metrics[0]["loss"] - first_loss) / abs(first_loss)
        if not rel <= PALLAS_LOSS_REL_MAX:
            raise AssertionError(f"{phase}: first-step loss {metrics[0]['loss']} vs {first_loss} "
                                 f"(relative {rel} > {PALLAS_LOSS_REL_MAX})")
    return state, batch, step_fn, counts, metrics[0]["loss"]


def phase_int8_tool(dev, rehearse: bool):
    """The int8 dense microbenchmark at a cut list of its shapes (1/64 of
    each M with plain math in rehearsal); every K7 result must equal the
    exact product."""
    from i2v_adapter_tpu_torch.ops import profile_int8_dense as tool

    shapes = [tool.SHAPES[i] for i in INT8_TOOL_SHAPES]
    if rehearse:
        shapes = [(m // 64, k, n) for m, k, n in shapes[:1]]
    reset_launch_counts()
    rows = tool.run(shapes, dev, iters=1 if rehearse else 5)
    counts = launch_counts()
    emit({"phase": "int8_tool", "rows": rows, "launches": counts})
    if not all(r["exact"] for r in rows):
        raise AssertionError(f"int8 tool: K7 differs from the exact product: {rows}")
    if not rehearse and counts["int8_matmul"] < len(shapes):
        raise AssertionError(f"int8 tool launched K7 {counts['int8_matmul']} times")
    return counts


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


# per summary row: (name, case list, counted wrapper, source, the TPU kernel
# it replaces, the paths whose launches count for it, the key that weights a
# case by its launches on that path)
CSRC = "i2v_adapter_tpu_torch/csrc/"
SUMMARY = (
    ("flash_attention", "flash_attention", "flash_attention", CSRC + "flash_attention.cu",
     "i2v_adapter_tpu/ops/attention.py:143", ("pipeline", "pipeline_pallas", "train", "train_pallas"),
     "launches_per_eval"),
    ("temporal_attention_cs", "temporal_attention_cs", "temporal_attention_cs",
     CSRC + "temporal_attention.cu", "i2v_adapter_tpu/ops/attention.py:985",
     ("pipeline", "pipeline_pallas", "train", "train_pallas"), "launches_per_eval"),
    ("flash_attention_bwd", "flash_attention_bwd", "flash_attention_bwd",
     CSRC + "flash_attention_bwd.cu", "i2v_adapter_tpu/ops/attention.py:518",
     ("train", "train_pallas"), "launches_per_step"),
    ("conv3x3_kernel", "conv3x3_kernel", "conv3x3_kernel", CSRC + "conv3x3.cu",
     "i2v_adapter_tpu/ops/conv3x3.py:44", ("pipeline_pallas", "train_pallas"), "launches_per_eval"),
    ("flash_attention[transposed_io=False]", "flash_attention_row_major", "flash_attention",
     CSRC + "flash_attention.cu", "i2v_adapter_tpu/ops/attention.py:85", ("layouts",),
     "launches_per_eval"),
    ("temporal_attention[impl=kernel]", "temporal_attention_forced", "temporal_attention_cs",
     CSRC + "temporal_attention.cu", "i2v_adapter_tpu/ops/attention.py:871", ("unet_forced_temporal",),
     "launches_per_eval"),
    ("int8_matmul", "int8_matmul", "int8_matmul", CSRC + "int8_matmul.cu",
     "i2v_adapter_tpu/ops/profile_int8_dense.py:103", ("int8_tool",), "launches_per_tool_run"),
)


def summary(rows, paths) -> dict:
    """Per kernel: launches on its main paths (each path counted from 0)
    and the launch-weighted mean per launch over its main-path shapes
    (weights: launches per serving UNet evaluation, per training step for
    K3, per tool run for K7)."""
    out = []
    for name, key, counter, source, replaces, on_paths, weight_key in SUMMARY:
        cases = rows[key]
        weight = lambda r: r.get(weight_key, 0)
        main = [r for r in cases if weight(r) > 0]
        w = sum(weight(r) for r in main)
        mean = lambda k: sum(r[k] * weight(r) for r in main) / w
        bytes_side = sum(weight(r) for r in main if r["bound_by"] == "bytes")
        by_path = {p: paths[p][counter] for p in on_paths}
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(v for r in cases for k, v in r.items() if k.startswith("abs_err")),
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
    unet, fused_unet, forced_counts = phase_unet(model_cfg, dev, dtype, rehearse)
    layout_counts = phase_layouts(dev, rehearse)
    counts, fused_counts = phase_pipeline(model_cfg, unet, fused_unet, dev, dtype, rehearse)
    del unet, fused_unet
    train_state, batch, step_fn, train_counts, first_loss = phase_train(model_cfg, dev, rehearse)
    phase_gradcheck(train_state, batch, step_fn, rehearse)
    del train_state, batch, step_fn
    fused_cfg = model_cfg.replace(unet=model_cfg.unet.replace(conv_impl="pallas"))
    fused_train_counts = phase_train(fused_cfg, dev, rehearse, steps=PALLAS_TRAIN_STEPS,
                                     phase="train_pallas", first_loss=first_loss)[3]
    tool_counts = phase_int8_tool(dev, rehearse)
    if rows is not None:
        kernels = summary(rows, {
            "pipeline": counts, "pipeline_pallas": fused_counts, "train": train_counts,
            "train_pallas": fused_train_counts, "layouts": layout_counts,
            "unet_forced_temporal": forced_counts, "int8_tool": tool_counts})
        idle = [k["name"] for k in kernels["kernels"] if k["launches"] <= 0]
        if idle:
            raise AssertionError(f"kernels never launched on their main path: {idle}")
        emit(kernels)
    print(info["nvidia_smi"], flush=True)
    if rehearse:
        emit({"ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 1}})
    else:
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
