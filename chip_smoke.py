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
                   128 tokens (its K6), the int8 matmul K7 (exact) at the
                   tool's shapes and the int8 downsamplers' im2col shapes
                   (with its dequantising epilogue), and the int8 3x3 conv
                   at every UNet and VAE-decoder site of the serving default
                   (int32 equal to the plain version, the dequantised output
                   within a bf16 rounding), and the grouped weight quantiser
                   over every int8 site in one launch (equal bit for bit)
4. ``unet``     -- one full-width (SD1.5) VideoUNet evaluation, kernels vs
                   plain attention, PSNR between the two; the same weights
                   with ``conv_impl='pallas'`` (every resnet stage through
                   K4) against ``'auto'``; the temporal kernel forced at
                   every site against ``'auto'``; with int8 convs (the
                   serving default) through the kernels against the plain
                   int8 convs, and against the exact convs (reported)
5. ``layouts``  -- ``flash_attention(transposed_io=False)`` on row-major
                   operands at the serving sites, against the default layout
6. ``pipeline`` -- two image-to-video requests through I2VAdapterPipeline at
                   512x512, 16 frames, CFG 7.5, IP-Adapter, bf16, seeded
                   random weights, one more with ``conv_impl='pallas'``, and
                   the serving default ``PipelineConfig()`` (int8 convs) on
                   the same weights, once for its latents and once decoded;
                   launch counts checked against the config
6b. ``scan``    -- ``dispatch='scan'`` (step kinds replayed from CUDA graphs)
                   against ``'stepwise'`` from the same seed at requests
                   (b), (d), (e) and (f)'s shapes at the serving default and
                   one ``conv_impl='pallas'`` request: equal bit for bit,
                   launches as derived with replays counted, step ms by kind
                   each way, capture ms, the graphs' pool; the step graphs
                   kept across calls: (b) repeated and (a)'s 25 steps at
                   (b)'s shape replay the kept entry with no capture, equal
                   bit for bit; after FreeU on, FreeU off, int8 on, an int8
                   weight quantised again and the trainer's validation swap
                   the next request captures afresh, equal to 'stepwise';
                   the kept pools within their budget; then a synthetic
                   full-width LoRA (peft and kohya layouts) merged, its int8
                   weights quantised again, a 5-step scan request capturing
                   afresh, equal to 'stepwise'
7. ``pretrained`` -- a full-width diffusers-layout checkpoint directory
                   (``I2VModelConfig()``, fp16, seeded random weights, the
                   77-token tokenizer) and an adapter task
                   ``checkpoint/<task>/epoch_1/i2v_adapter`` with nonzero
                   weights, written by ``tests/torch_port_synth.py`` and
                   loaded with ``I2VAdapterPipeline.from_pretrained``: bytes,
                   write and load seconds, the host's peak RSS, the card's
                   peak memory; the adapter merged, the IP head standard
8. ``serve``    -- the daemon, ``pipelines.serve.main``, on that directory and
                   task at the serving default over its queue: (a) the CLI's
                   defaults (512x512, 16 frames, 25 steps cut to 22, CFG
                   7.5), (b) 5 steps, another seed, ``npy``, (c) a missing
                   image, (d) ``encoder_cache: 2`` and (e) ``cfg_cutoff:
                   0.5`` at 25 steps, (j) a request over the card's memory
                   envelope, (f) a 48-frame clip (4 anchored temporal
                   windows, 5 steps); (c) and (j) fail with the worker
                   serving on, each request's launches equal the config's
                   and its dispatch is reported ((a) takes 'auto' -> 'scan',
                   (b) replays the step graphs (a) kept);
                   (a)'s ``latency_s`` and phase times are the clip latency;
                   (d)'s full and cached, (e)'s CFG and cond-only step times
8b. ``serve_heads`` -- ``from_pretrained`` of the same directory: with the
                   standard head, the card's memory budgets (peak memory of
                   one 512 px UNet evaluation at 32 and 64 frame-evaluations,
                   the encoder cache of one full step, one evaluation and one
                   'scan' request at the pipeline's envelope, all beside a
                   kept 16-frame request's step graphs), ``vae_tiling``'s tiled decode of 16
                   frames at 768 px against the untiled one, and (g) a FreeU
                   request (``enable_freeu``); with (h) a plus and (i) a
                   full_face IP-Adapter file written beside the directory, one
                   request each, through the daemon's loop (``serve.serve``)
9. ``cli``      -- ``pipelines.cli.main`` on a one-row CSV with the same task,
                   ``--no-int8_conv``, 5 steps: one GIF
9a. ``mesh``    -- one clip over several cards: one rank per visible card,
                   spawned as ``--mesh`` spawns them, at full width, 512 px,
                   16 frames, the serving default, 5 steps; on 1 card the
                   (1,1,1) mesh, equal bit for bit to the unmeshed clip
                   (``"ranks": 1``); on 4 cards (2,1,2), (1,1,4) and (2,2,1),
                   each UNet evaluation over 40 dB PSNR against one card
                   (int8 and exact convs), each exact-conv clip over 35 dB,
                   each int8 clip within 1 dB of the card's own rounding
                   perturbation of it (attention through the plain
                   version), and the daemon's request (a) at (2,1,2)
                   through ``serve.main --mesh``, twice; per mesh the
                   latency, step and decode ms, each rank's peak memory and
                   launches (held to the config's local counts) and one
                   step's collectives (count, bytes, ms; held to
                   ``parallel.audit``'s formula).  ``--only mesh`` runs the
                   device, build and mesh phases alone
9a'. ``mesh_train`` -- the train step over a mesh of ranks, one per visible
                   card, at config 4 (SD1.5 widths, 2 clips x 16 frames a
                   data x fsdp way, 256 px, bf16, remat, AdamW; seeded
                   random weights, a synthetic batch): on 1 card the
                   (1,1,1,1) mesh through a spawned rank, its first step's
                   loss and trainable gradients and two steps equal bit for
                   bit to the unmeshed step's (within the gradcheck limits
                   only if the unmeshed step itself does not repeat bit for
                   bit); on 4 cards (``--only mesh_train``) the JAX audit's
                   train meshes that fit them: (4,1,1,1), (2,2,1,1) with the
                   frozen weights sharded and replicated, (2,1,1,2),
                   (2,1,2,1) and the 512 px motion finetune at (1,2,1,2)
                   with 1 clip a way, each rank's gradients against one
                   card's weighted micro-batches of 2 clips within the
                   gradcheck limits, step ms (mean of steps 2-5), one
                   step's collectives (count, bytes, ms; held to
                   ``collectives_per_train_step``), each rank's peak memory
                   and K1 / K2 / K3 launches (held to the local counts)
9b. ``driver``  -- ``training/driver.py``'s ``main`` on that directory at the
                   reference training workload (config 4, EMA) over 12
                   WebVid-layout clips (64 frames at 336 x 256, OpenCV's
                   mp4v; the phase fails without OpenCV) decoded
                   and preprocessed on the host: 6 steps with full-state
                   saves at 3 and 6, the epoch's adapter checkpoint and a
                   validation GIF; ``--resume_from_checkpoint latest`` for
                   3 more steps, the restored state equal to the saved one
                   bit for bit, its save asynchronous; the newest epoch
                   checkpoint loaded by ``from_pretrained`` (its adapter
                   equal to the trained EMA) and one 5-step request served;
                   the final export read back; 2 steps of ``--train_mode
                   t2i``.  Every train
                   step's K1 / K2 / K3 launches equal the config's, no int8
                   launch; step ms, the host's data wait, save bytes and
                   seconds, the card's peak
9c. ``latent``  -- the latent-diffusion zoo: the offline encoders on that
                   directory, SimpleUNet3D / SimpleUNet train steps, both
                   1000-step samplers with CFG replayed from CUDA graphs and
                   held bit for bit to their eager loops (ms a step each
                   way), a dome forward, the checkpoints; K1 / K3 launches
                   as derived
10. ``train``   -- the adapter training step at the reference workload
                   (``reference_train_config``: SD1.5 widths, 2 clips x 16
                   frames at 256 px, bf16 with
                   fp32 trainables, frozen weights in bf16, activation
                   checkpointing, AdamW), seeded random weights and a
                   synthetic batch: 1 warm-up + 4 timed steps; loss finite,
                   no step skipped, every trainable moved, no frozen weight
                   moved, K1/K2/K3 launches as derived from the config
11. ``gradcheck`` -- trainable gradients with the kernels vs with plain
                   attention over three seeds' draws (relative L2 error and
                   cosine over all trainables, worst leaf's relative L2),
                   and planted K3 faults that the limits must catch
12. ``train_pallas`` -- the same training workload with ``conv_impl='pallas'``:
                   1 warm-up + 2 timed steps, first-step loss within 2 % of
                   the ``'auto'`` run's on the same draws, K4 launched twice
                   per resnet conv per step (forward + recompute)
13. ``int8_tool`` -- ``ops.profile_int8_dense`` at a cut list of its shapes
14. ``profilers`` -- ``ops.trace_unet`` (the per-module split of one int8
                   evaluation's device time, its sums held to the profiler's
                   total), ``ops.profile_unet`` (seven variants, launches as
                   derived), ``ops.profile_motion`` and ``ops.tune`` at
                   reduced iterations, their records checked

The ``pretrained`` directory, the clips and what the driver writes live
under ``chip_smoke_work/`` beside this script (git-ignored), removed at
the end.
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
import os
import re
import resource
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# card peaks (H100 SXM data sheet, dense): bf16 and int8 tensor cores, fp32
# outside the tensor cores, HBM
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# NVLink 4 between two H100 SXM cards of one host: 900 GB/s both ways
# together, 450 GB/s each way
PEAK_NVLINK_BYTES = 450e9

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
# the counted kernel wrappers (K1, K3, K2, K4, K7, the int8 3x3 conv, its
# grouped weight quantiser, the GroupNorm kernel, and SVD's frame
# convolution, which no SD1.5 path runs)
KERNELS = ("flash_attention", "flash_attention_bwd", "temporal_attention_cs", "conv3x3_kernel",
           "int8_matmul", "int8_conv3x3_kernel", "quantize_weights", "group_norm_fused", "temporal_conv3")


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
    """Launches of every counted kernel wrapper since the last reset (a
    CUDA graph's launches counted at each replay: ``ops.launches``)."""
    from i2v_adapter_tpu_torch.ops import launches

    return launches.snapshot()


def reset_launch_counts() -> None:
    from i2v_adapter_tpu_torch.ops import launches

    launches.reset()


def expected_counts(**counts) -> dict:
    return {name: counts.get(name, 0) for name in KERNELS}


# ---------------------------------------------------------------------------
# launch counts derived from the config
# ---------------------------------------------------------------------------


def launches_per_unet_eval(ucfg, latent: int, cross_frame: bool, flash_min: int = 128,
                           temporal_min: int = 128, ip_tokens: int = 0, cached: bool = False):
    """(flash, temporal) kernel launches of one VideoUNet evaluation under
    the 'auto' dispatch: flash for attention with >= 128 keys (attn1, and
    the adapter when cross-frame is on, and the IP attention when the IP
    head gives ``ip_tokens`` >= 128 tokens: full_face's 257), temporal for
    motion modules with S >= 128 tokens (two attentions each).
    ``flash_min`` counts only the flash sites with at least that many keys;
    ``temporal_min=0`` counts the temporal kernel forced at every motion
    module; ``cached`` counts an evaluation from cached down-path features
    (``encoder_cache=2``), which runs mid and up only."""
    flash = temporal = 0
    n = ucfg.num_blocks
    per_block = ucfg.transformer_layers_per_block * (
        1 + (1 if ucfg.use_i2v_adapter and cross_frame else 0)
    )
    ip_per_block = ucfg.transformer_layers_per_block if ip_tokens >= max(128, flash_min) else 0

    def site(tokens, layers, has_attn, motion):
        nonlocal flash, temporal
        if tokens >= max(128, flash_min) and has_attn:
            flash += layers * per_block
        if has_attn:
            flash += layers * ip_per_block
        if tokens >= temporal_min and motion:
            temporal += layers * 2

    for i in range(0 if cached else n):
        s = (latent >> i) ** 2
        site(s, ucfg.layers_per_block, ucfg.down_block_has_attention[i], ucfg.use_motion_modules)
    s_mid = (latent >> (n - 1)) ** 2
    site(s_mid, 1, True, ucfg.use_motion_modules and ucfg.use_motion_mid_block)
    for i in range(n):
        s = (latent >> (n - 1 - i)) ** 2
        site(s, ucfg.layers_per_block + 1, ucfg.up_block_has_attention[i], ucfg.use_motion_modules)
    return flash, temporal


def _resnet_conv_sites(ucfg, latent: int, cached: bool = False) -> dict:
    """``{(H, C, Cout): launches}``: the 3x3 convs of one VideoUNet
    evaluation's 22 resnets (two per resnet: C -> Cout and Cout -> Cout at
    the block's resolution H = W); ``cached`` leaves out the down path's."""
    sites, chans, n = {}, ucfg.block_out_channels, ucfg.num_blocks

    def resnet(h, cin, cout, count=True):
        for shape in ((h, cin, cout), (h, cout, cout)):
            sites[shape] = sites.get(shape, 0) + int(count)

    skips, cin = [chans[0]], chans[0]
    for i in range(n):
        for j in range(ucfg.layers_per_block):
            resnet(latent >> i, cin if j == 0 else chans[i], chans[i], count=not cached)
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
    return {k: v for k, v in sites.items() if v}


def conv_sites(ucfg, latent: int):
    """``[(H, C, Cout, launches)]``: every distinct shape that one VideoUNet
    evaluation with ``conv_impl='pallas'`` gives K4 (the resnet convs), with
    how often it is launched; empty under the other impls and under int8,
    which wins over the fused conv."""
    if ucfg.conv_impl != "pallas" or ucfg.int8_conv:
        return []
    return [(h, c, co, count) for (h, c, co), count in _resnet_conv_sites(ucfg, latent).items()]


def int8_unet_sites(ucfg, latent: int, cached: bool = False):
    """``[(H, C, Cout, launches)]``: the stride-1 int8 convs of one VideoUNet
    evaluation under ``int8_conv`` (the int8 conv kernel's shapes): the
    resnet convs, and each up block's upsample conv at the doubled
    resolution (47 at SD1.5 width; 31 for a ``cached`` evaluation)."""
    sites = _resnet_conv_sites(ucfg, latent, cached)
    chans, n = ucfg.block_out_channels, ucfg.num_blocks
    for i, out in enumerate(reversed(chans)):
        if i < n - 1:
            key = (latent >> (n - 2 - i), out, out)
            sites[key] = sites.get(key, 0) + 1
    return [(h, c, co, count) for (h, c, co), count in sites.items()]


def int8_downsample_sites(ucfg, latent: int, cached: bool = False):
    """``[(H, C, Cout, launches)]``: the stride-2 int8 convs of one
    evaluation under ``int8_conv`` (input resolution H), each an int8 im2col
    and one K7 launch of M = B*(H/2)^2, K = 9*C, N = Cout; none in a
    ``cached`` evaluation (no down path)."""
    chans = ucfg.block_out_channels
    return [] if cached else [(latent >> i, chans[i], chans[i], 1) for i in range(ucfg.num_blocks - 1)]


def int8_decoder_sites(vcfg, latent: int):
    """``[(H, C, Cout, launches)]``: the int8 convs of one VAE decode under
    ``int8_decode`` from ``latent``-sized latents: the mid block's and up
    blocks' resnet convs and the upsample convs (31 at SD1.5 width)."""
    rev = tuple(reversed(vcfg.block_out_channels))
    sites = {(latent, rev[0], rev[0]): 4}
    cin = rev[0]
    for i, ch in enumerate(rev):
        h = latent << i
        for _ in range(vcfg.layers_per_block + 1):
            for key in ((h, cin, ch), (h, ch, ch)):
                sites[key] = sites.get(key, 0) + 1
            cin = ch
        if i < len(rev) - 1:
            key = (h * 2, ch, ch)
            sites[key] = sites.get(key, 0) + 1
    return [(h, c, co, count) for (h, c, co), count in sites.items()]


def unet_group_norm_sites(ucfg, cached: bool = False) -> list:
    """``[(block, kind, channels)]``: the GroupNorms of one VideoUNet
    evaluation in the order they run (``block``: 'down<i>', 'mid', 'up<i>'
    or 'out', the units activation checkpointing recomputes; ``kind``:
    'resnet' for a resnet's norm1 / norm2, 'attention' for a spatial
    transformer's, 'motion' for a motion module's, 'out' for
    ``conv_norm_out``): 82 at SD1.5; ``cached`` leaves out the down path's
    (52)."""
    chans, n, layers = ucfg.block_out_channels, ucfg.num_blocks, ucfg.layers_per_block
    sites = []

    def layer(block, cin, cout, attention, motion):
        sites.extend([(block, "resnet", cin), (block, "resnet", cout)] + [(block, "attention", cout)] * attention
                     + [(block, "motion", cout)] * motion)

    skips, cin = [chans[0]], chans[0]
    for i in range(n):
        for j in range(layers):
            if not cached:
                layer(f"down{i}", cin if j == 0 else chans[i], chans[i], ucfg.down_block_has_attention[i],
                      ucfg.use_motion_modules)
            skips.append(chans[i])
        if i < n - 1:
            skips.append(chans[i])
        cin = chans[i]
    layer("mid", chans[-1], chans[-1], True, ucfg.use_motion_modules and ucfg.use_motion_mid_block)
    sites.extend([("mid", "resnet", chans[-1])] * 2)
    x_ch = chans[-1]
    for i, out in enumerate(reversed(chans)):
        for j in range(layers + 1):
            layer(f"up{i}", (x_ch if j == 0 else out) + skips.pop(), out, ucfg.up_block_has_attention[i],
                  ucfg.use_motion_modules)
        x_ch = out
    return sites + [("out", "out", chans[0])]


def _group_norm_takes(channels: int, groups: int, dtype) -> bool:
    from i2v_adapter_tpu_torch.ops.norms import group_norm_takes

    return group_norm_takes(channels, groups, dtype)


def _unet_group_norms(ucfg, sites, dtype) -> int:
    """The GroupNorm kernel's calls among ``sites`` of ``unet_group_norm_sites``
    with no gradient recorded: each site whose width the kernel takes
    (``ops.norms.group_norm_takes``), but a resnet's under
    ``conv_impl='pallas'`` without int8, whose norm K4 takes folded
    (``ops.norms.fold_gn_affine``)."""
    folded = ucfg.conv_impl == "pallas" and not ucfg.int8_conv
    return sum(not (folded and kind == "resnet") and _group_norm_takes(c, ucfg.norm_num_groups, dtype)
               for _, kind, c in sites)


def group_norms_per_unet_eval(ucfg, cached: bool = False, dtype=torch.bfloat16) -> int:
    """The GroupNorm kernel's calls in one VideoUNet evaluation with no
    gradient recorded (82 at SD1.5 in bf16, 38 with K4's folded resnet
    norms; 52 in a ``cached`` one): whatever the batch and resolution."""
    return _unet_group_norms(ucfg, unet_group_norm_sites(ucfg, cached), dtype)


def vae_group_norm_sites(vcfg, part: str) -> list:
    """The channels of each GroupNorm of one VAE ``part`` call ('encoder':
    22 at SD1.5, 'decoder': 30), in the order they run."""
    chans, layers = vcfg.block_out_channels, vcfg.layers_per_block
    if part == "encoder":
        sites, cin = [], chans[0]
        for ch in chans:
            for _ in range(layers):
                sites += [cin, ch]
                cin = ch
        return sites + [chans[-1]] * 6  # mid resnets, mid attention, conv_norm_out
    rev = tuple(reversed(chans))
    sites, cin = [rev[0]] * 5, rev[0]  # mid resnets and attention
    for ch in rev:
        for _ in range(layers + 1):
            sites += [cin, ch]
            cin = ch
    return sites + [rev[-1]]


def group_norms_per_vae_call(vcfg, part: str, dtype=torch.bfloat16) -> int:
    """The GroupNorm kernel's calls in one VAE encoder or decoder call with
    no gradient recorded (one decoder call per tile or slice)."""
    return sum(_group_norm_takes(c, vcfg.norm_num_groups, dtype) for c in vae_group_norm_sites(vcfg, part))


def group_norms_per_request(model_cfg, evals: int, cached_evals: int = 0, decode_calls: int = 1) -> int:
    """The GroupNorm kernel's calls in one bf16 serving request: its UNet
    evaluations (``cached_evals`` of them from cached down-path features),
    the condition image's one encoder call and ``decode_calls`` decoder
    calls."""
    return (evals * group_norms_per_unet_eval(model_cfg.unet)
            + cached_evals * group_norms_per_unet_eval(model_cfg.unet, cached=True)
            + group_norms_per_vae_call(model_cfg.vae, "encoder")
            + decode_calls * group_norms_per_vae_call(model_cfg.vae, "decoder"))


def group_norms_per_train_step(model_cfg, tcfg, images: int) -> int:
    """The GroupNorm kernel's calls in one train step on ``images`` frames:
    the conditioning's VAE encode under no grad (one encoder call, or one a
    ``vae_encode_slice`` of the frames), then, under autograd, the UNet's
    norms that run before the first trainable one: in i2v mode those ahead
    of the first adapter (a spatial transformer's norm runs before its
    adapter) or of a trained motion module, with frozen weights and an input
    that carries no gradient (3 at SD1.5: the first resnet's two and the
    first transformer's); again in the backward's recompute of the block
    that holds the first trainable module, under activation checkpointing
    (the blocks ahead of it record nothing, so nothing recomputes them).  In
    t2i mode every UNet weight trains: none."""
    ucfg, dtype = model_cfg.unet, torch.bfloat16 if tcfg.mixed_precision == "bfloat16" else torch.float32
    s = tcfg.vae_encode_slice
    encodes = images // s if 0 < s < images and images % s == 0 else 1
    count = encodes * group_norms_per_vae_call(model_cfg.vae, "encoder", dtype)
    if tcfg.train_mode == "t2i":
        return count
    sites = unet_group_norm_sites(ucfg)
    first = next(i for i, (_, kind, _) in enumerate(sites) if (kind == "attention" and ucfg.use_i2v_adapter)
                 or (kind == "motion" and tcfg.update_motion_modules) or kind == "out")
    lead = sites[:first + int(sites[first][1] == "attention")]
    block = [site for site in lead if site[0] == sites[first][0] != "out"]
    recompute = _unet_group_norms(ucfg, block, dtype) if tcfg.gradient_checkpointing else 0
    return count + _unet_group_norms(ucfg, lead, dtype) + recompute


def clip_denoise_steps(steps: int = 25, strength: float = 0.9) -> int:
    """Denoise steps of a serving clip (BASELINE config 2: 25 DDIM steps cut
    by strength 0.9)."""
    from i2v_adapter_tpu_torch.config import SchedulerConfig
    from i2v_adapter_tpu_torch.schedulers import ddim_schedule_arrays

    return len(ddim_schedule_arrays(SchedulerConfig(), steps, strength)[0])


def int8_launches(model_cfg, latent: int, cached: bool = False) -> dict:
    """Launches of the int8 conv kernel, of K7 and of the weight quantiser
    per serving UNet evaluation (a ``cached`` one: mid and up only), per
    decode and per load under the serving default: the weights are
    quantised once per weights version, in one grouped launch for every
    int8 site of the pipeline (when it is built, when int8 is switched on,
    after a LoRA merge), none per evaluation or decode."""
    ucfg = model_cfg.unet.replace(int8_conv=True)
    convs = sum(n for *_, n in int8_unet_sites(ucfg, latent, cached))
    downs = sum(n for *_, n in int8_downsample_sites(ucfg, latent, cached))
    dec = sum(n for *_, n in int8_decoder_sites(model_cfg.vae, latent))
    return {"per_eval": {"int8_conv3x3_kernel": convs, "int8_matmul": downs, "quantize_weights": 0},
            "per_decode": {"int8_conv3x3_kernel": dec, "int8_matmul": 0, "quantize_weights": 0},
            "per_load": {"int8_conv3x3_kernel": 0, "int8_matmul": 0, "quantize_weights": 1}}


# the driver's validation: 25 steps at the serving default (int8 convs),
# one clip per row of the eval CSV, once per validated epoch
DRIVER_RESOLUTION = 256
VALIDATION_STEPS = 25


def validation_int8_launches(model_cfg, latent: int, clips: int = 1) -> dict:
    """The int8 launches of one ``_run_validation`` of ``clips`` clips:
    each clip's UNet evaluations and decode, and one weight quantiser
    launch (the trained weights swapped in are a new weights version)."""
    steps = clip_denoise_steps(VALIDATION_STEPS)
    per = int8_launches(model_cfg, latent)
    return {k: clips * (steps * per["per_eval"][k] + per["per_decode"][k]) + per["per_load"][k]
            for k in per["per_eval"]}


def request_launches(model_cfg, latent: int, steps: int, *, ip_tokens: int = 0, encoder_cache: int = 1,
                     windows: int = 1, decode_calls: int = 1, int8: bool = True) -> dict:
    """Every counted kernel's launches in one request of ``steps`` denoise
    steps: each step evaluates the UNet once per temporal window (launches
    per evaluation do not depend on its batch, so a cond-only step counts
    as a CFG one); under ``encoder_cache=2`` every second step of the
    leading pairs is a cached evaluation; then ``decode_calls`` decoder
    calls (slices or tiles; 0 for latents); the GroupNorm kernel also in
    the condition image's encode (``group_norms_per_request``)."""
    cached = steps // 2 if encoder_cache > 1 else 0
    full = steps - cached
    counts = {}
    for n_evals, is_cached in ((full, False), (cached, True)):
        flash, temporal = launches_per_unet_eval(model_cfg.unet, latent, True, ip_tokens=ip_tokens,
                                                 cached=is_cached)
        add = {"flash_attention": flash, "temporal_attention_cs": temporal}
        if int8:
            add.update(int8_launches(model_cfg, latent, is_cached)["per_eval"])
        for k, v in add.items():
            counts[k] = counts.get(k, 0) + n_evals * windows * v
    if int8:
        for k, v in int8_launches(model_cfg, latent)["per_decode"].items():
            counts[k] = counts.get(k, 0) + decode_calls * v
    counts["group_norm_fused"] = group_norms_per_request(model_cfg, full * windows, cached * windows, decode_calls)
    return expected_counts(**counts)


def conv_launches_per_unet_eval(ucfg) -> int:
    """K4 launches of one VideoUNet evaluation (the resolution does not
    change the count)."""
    return sum(count for *_, count in conv_sites(ucfg, 64))


def launches_per_train_step(model_cfg, latent: int, tcfg, min_nk: int = 1024) -> dict:
    """Kernel launches of one train step on ``tcfg``'s batch: K1 and K2 at
    every site of the forward, again in the backward's recompute under
    activation checkpointing; K3 at every flash site with ``nk >= min_nk``
    whose inputs carry a gradient; K4 twice per resnet conv under
    ``conv_impl='pallas'`` (its backward is plain); the GroupNorm kernel as
    ``group_norms_per_train_step`` counts it.  In i2v mode the first
    transformer block's self-attention sees frozen weights only (nothing
    trainable runs before it unless motion modules train and precede it),
    so its backward is never taken."""
    ucfg = model_cfg.unet
    cross_frame = tcfg.train_mode != "t2i"
    flash, temporal = launches_per_unet_eval(ucfg, latent, cross_frame)
    bwd = launches_per_unet_eval(ucfg, latent, cross_frame, flash_min=min_nk)[0]
    # the first attention level (the mid block's when no down block has one)
    first = next((i for i, a in enumerate(ucfg.down_block_has_attention) if a), ucfg.num_blocks - 1)
    motion_before = tcfg.update_motion_modules and ucfg.use_motion_modules and first > 0
    if tcfg.train_mode == "i2v" and not motion_before and (latent >> first) ** 2 >= min_nk:
        bwd -= 1
    recompute = 2 if tcfg.gradient_checkpointing else 1
    images = tcfg.train_batch_size * (1 if tcfg.train_mode == "t2i" else tcfg.num_frames)
    return {"flash_attention": recompute * flash, "flash_attention_bwd": bwd,
            "temporal_attention_cs": recompute * temporal,
            "conv3x3_kernel": recompute * conv_launches_per_unet_eval(ucfg),
            "group_norm_fused": group_norms_per_train_step(model_cfg, tcfg, images)}


# the latent phase: the zoo at its defaults, 2 clips x 16 frames of 256 px
# (32x32 latents) for SimpleUNet3D, 8 images of 512 px (64x64 latents) for
# SimpleUNet, 1 warm-up + 4 timed steps each, 2 image_only steps on single
# frames, and two samplers over every one of the 1000 train timesteps
LATENT_ZOO = {"widths": (64, 128, 256), "attention_levels": (False, True, True), "heads": 4}
LATENT_CLIPS, LATENT_CLIP_FRAMES, LATENT_FRAMES, LATENT_VIDEO_BATCH = 4, 64, 16, 2
LATENT_IMAGES, LATENT_IMAGE_BATCH, LATENT_IMAGE_ONLY_STEPS = 16, 8, 2
LATENT_VIDEO_SIZE, LATENT_IMAGE_SIZES = 256, (256, 512)
LATENT_SAMPLE_TIMESTEPS, LATENT_GUIDANCE = 1000, 7.5
LATENT_DOME_BATCH = 8


def simple_eval_sites(zoo: dict, latent: int, video: bool = False, cross: bool = True, frames: int = 1,
                      train: bool = False, min_nk: int = 1024) -> dict:
    """K1 / K3 launches of one evaluation of a zoo UNet (SimpleUNet, or
    SimpleUNet3D with ``video``) on ``latent`` x ``latent`` latents, by site
    shape: ``{(kernel, rows, keys, d): launches}``, where ``rows`` is the
    attention sequences per sample (``frames`` for a video UNet's spatial
    sites, the tokens for its temporal ones), so that a batch of ``b``
    samples launches the kernel at ``b * rows`` sequences.  K1 runs every
    self-attention with >= 128 keys: one per transformer block of
    SimpleUNet (down and up at each attention level, and the mid block),
    per attention site of SimpleUNet3D the VideoTransformer's spatial block
    and, given a context (``cross``), the cross block's self-attention;
    their temporal blocks attend over ``frames`` keys and the
    cross-attention over the 77 context tokens.  With ``train`` K3 runs at
    every K1 site with >= ``min_nk`` keys (every parameter trains, so every
    site's inputs carry a gradient).  The dome's attention is plain math."""
    n = len(zoo["widths"])
    levels = [i for i in range(n) if zoo["attention_levels"][i]] * 2 + [n - 1]
    out = {}
    for level in levels:
        tokens, d = (latent >> level) ** 2, zoo["widths"][level] // zoo["heads"]
        spatial_rows = frames if video else 1
        sites = [(spatial_rows, tokens)] * (1 + int(video and cross)) + ([(tokens, frames)] if video else [])
        for rows, keys in sites:
            for kernel, runs in (("flash_attention", keys >= 128), ("flash_attention_bwd", train and keys >= min_nk)):
                if runs:
                    out[(kernel, rows, keys, d)] = out.get((kernel, rows, keys, d), 0) + 1
    return out


def launches_per_simple_eval(zoo: dict, latent: int, **kwargs) -> dict:
    """``simple_eval_sites``' launches summed by kernel (a CFG-doubled batch
    is one evaluation either way)."""
    out = {"flash_attention": 0, "flash_attention_bwd": 0}
    for (kernel, *_), count in simple_eval_sites(zoo, latent, **kwargs).items():
        out[kernel] += count
    return out


def module_group_norms(model: torch.nn.Module, dtype=torch.float32) -> int:
    """The GroupNorm kernel's calls in one forward with no gradient recorded
    of a model that runs each of its ``GroupNorm`` modules once (the zoo's
    UNets, the dome): every module whose width the kernel takes."""
    from i2v_adapter_tpu_torch.models.layers import GroupNorm

    return sum(_group_norm_takes(m.weight.numel(), m.num_groups, dtype)
               for m in model.modules() if isinstance(m, GroupNorm))


def latent_run_launches(zoo: dict, steps: int, timesteps: int) -> dict:
    """The latent phase's launches by K1 / K3 shape ``(kernel, bq, n, d)``
    (``bq`` = batch x rows): ``steps`` steps of each trainer (warm-up
    included), ``LATENT_IMAGE_ONLY_STEPS`` image_only steps (single frames
    lifted to T = 1) and the two samplers over ``timesteps`` steps each
    (CFG doubles their batch of 1)."""
    video_lat, image_lat = LATENT_VIDEO_SIZE // 8, LATENT_IMAGE_SIZES[1] // 8
    runs = (  # batch, latent, evaluation, count
        (LATENT_VIDEO_BATCH, video_lat, dict(video=True, frames=LATENT_FRAMES, train=True), steps),
        (LATENT_VIDEO_BATCH, video_lat, dict(video=True, frames=1, train=True), LATENT_IMAGE_ONLY_STEPS),
        (LATENT_IMAGE_BATCH, image_lat, dict(train=True), steps),
        (2, video_lat, dict(video=True, frames=LATENT_FRAMES), timesteps),
        (2, video_lat, {}, timesteps),
    )
    out = {}
    for batch, latent, evaluation, count in runs:
        for (kernel, rows, keys, d), n in simple_eval_sites(zoo, latent, **evaluation).items():
            key = (kernel, batch * rows, keys, d)
            out[key] = out.get(key, 0) + count * n
    return out


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


# kernels whose ptxas report must show no spills (the wgmma kernels, the
# backward's pre-pass and the temporal tensor-core kernel)
NO_SPILL = re.compile(r"wgmma_kernel|bwd_prep_kernel|temporal_mma_kernel")


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
    name = re.compile(r"(flash_fwd_wgmma_kernel|flash_fwd_kernel|temporal_mma_kernel|temporal_fwd_kernel"
                      r"|bwd_dq_wgmma_kernel|bwd_dkv_wgmma_kernel|bwd_dq_mma_kernel|bwd_dkv_mma_kernel"
                      r"|bwd_dq_kernel|bwd_dkv_kernel|bwd_prep_kernel|int8_conv3x3_wgmma_kernel"
                      r"|int8_mm_wgmma_kernel|conv3x3_wgmma_kernel|conv3x3_f32_kernel"
                      r"|group_norm_stats_kernel|group_norm_apply_kernel)I(\w*?)EE")
    for r in report.values():
        for ln in r["ptxas"].splitlines():
            m = name.search(ln)
            if "injected" in ln and m:
                key = f"{m[1]}<{m[2]}>"
                injected[key] = injected.get(key, 0) + 1
            elif m:
                kernel = f"{m[1]}<{m[2].replace('13__nv_bfloat16', 'bf16')}>"
            elif "Compiling entry function" in ln or "Function properties for" in ln:
                # a kernel the names above do not know: its own symbol, so
                # that its report is not charged to the kernel before it
                symbol = re.search(r"_Z\w+", ln)
                kernel = symbol[0] if symbol else "?"
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


def _flash_case(name, bq, bkv, n, d, static_max, dev, iters, weight, row_major=False, nk=None,
                other_weights=None, heads=8):
    """One K1 shape: kernel vs plain in fp32 and bf16, then bf16 timings.
    ``n`` queries and ``nk`` keys (default ``n``).  ``row_major`` stores q,
    k, v as (B, H, N, D) and calls the ``transposed_io=False`` entry (the
    reference's row-major kernel, K5).  ``other_weights`` adds launch
    weights on other paths (e.g. per full_face evaluation)."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops.attention import _plain_attention, flash_attention

    h = heads
    nk = n if nk is None else nk
    g = torch.Generator(device=dev).manual_seed(bq * 7919 + n * 31 + d + (nk - n) * 7)
    rep = bq // bkv
    scale = 1.0 / math.sqrt(d)
    if row_major:
        q32, k32, v32 = (torch.randn(b, h, t, d, generator=g, device=dev).transpose(1, 2)
                         for b, t in ((bq, n), (bkv, nk), (bkv, nk)))
    else:
        # q as a strided view of a wider (fused-projection-like) buffer
        q32 = torch.randn(bq, n, 2 * h * d, generator=g, device=dev)[..., : h * d].unflatten(-1, (h, d))
        k32 = torch.randn(bkv, nk, h, d, generator=g, device=dev)
        v32 = torch.randn(bkv, nk, h, d, generator=g, device=dev)
    row = {"name": name, "bq": bq, "bkv": bkv, "kv_repeat": rep, "n": n, "nk": nk, "d": d,
           "heads": h, "static_max": static_max, "launches_per_eval": weight, **(other_weights or {}),
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
    flops = 4.0 * bq * h * n * nk * d
    nbytes = 2.0 * h * d * (2 * bq * n + 2 * bkv * nk)
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    ok = row["rel_err_fp32"] <= TOL_FP32 and row["rel_err_bf16"] <= TOL_BF16
    ok = ok and row["finite_fp32"] and row["finite_bf16"]
    # the logsumexp is fp32 from fp32 scores on both sides, whatever the input dtype
    ok = ok and max(row["lse_rel_err_fp32"], row["lse_rel_err_bf16"]) <= TOL_FP32
    return row, ok


def _flash_bwd_case(name, bq, bkv, n, d, dev, iters, weight, heads=8, other_weights=None):
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

    h = heads
    g = torch.Generator(device=dev).manual_seed(bq * 7919 + n * 31 + d + 1)
    rep = bq // bkv
    scale = 1.0 / math.sqrt(d)
    q32 = torch.randn(bq, n, 2 * h * d, generator=g, device=dev)[..., : h * d].unflatten(-1, (h, d))
    k32 = torch.randn(bkv, n, h, d, generator=g, device=dev)
    v32 = torch.randn(bkv, n, h, d, generator=g, device=dev)
    g32 = torch.randn(bq, n, h, d, generator=g, device=dev)
    row = {"name": name, "bq": bq, "bkv": bkv, "kv_repeat": rep, "n": n, "d": d, "heads": h,
           "static_max": 64.0, "launches_per_step": weight, **(other_weights or {})}
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


def _zoo_flash_case(name, bq, n, d, dev, iters, latent_weight):
    """K1 at a latent-zoo shape, in fp32 (the zoo's dtype: K1's scalar path)
    with 4 heads and the exact running max, as the zoo calls it: with the
    logsumexp where training takes K3 (``n >= FLASH_BWD_MIN_NK``).  Times
    in fp32: the kernel, its plain version and fp32 SDPA; the bound at the
    card's fp32 rate outside the tensor cores.  ``latent_weight`` is the
    shape's launches in one latent phase."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops.attention import FLASH_BWD_MIN_NK, _plain_attention, flash_attention

    h, scale, with_lse = 4, 1.0 / math.sqrt(d), n >= FLASH_BWD_MIN_NK
    g = torch.Generator(device=dev).manual_seed(bq * 7919 + n * 31 + d + 5)
    q = torch.randn(bq, n, 3 * h * d, generator=g, device=dev)[..., : h * d].unflatten(-1, (h, d))
    k, v = (torch.randn(bq, n, h, d, generator=g, device=dev) for _ in range(2))
    got, lse = flash_attention(q, k, v, scale=scale, static_max=0.0, with_lse=True)
    want, want_lse = _plain_attention(q, k, v, 1, scale, 0.0, with_lse=True)
    row = {"name": name, "bq": bq, "bkv": bq, "kv_repeat": 1, "n": n, "nk": n, "d": d, "heads": h,
           "static_max": 0.0, "dtype": "fp32", "with_lse": with_lse, "launches_per_eval": 0,
           "launches_per_latent_run": latent_weight, "rel_err_fp32": rel_err(got, want),
           "abs_err_fp32": abs_err(got, want), "lse_rel_err_fp32": rel_err(lse, want_lse),
           "finite_fp32": bool(torch.isfinite(got).all())}
    row["ms"] = device_ms(lambda: flash_attention(q, k, v, scale=scale, static_max=0.0, with_lse=with_lse), iters)
    row["plain_ms"] = device_ms(lambda: _plain_attention(q, k, v, 1, scale, 0.0, with_lse=with_lse), 3)
    row["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale), iters)
    flops = 4.0 * bq * h * n * n * d
    nbytes = 4.0 * h * d * 4 * bq * n + (4.0 * bq * h * n if with_lse else 0.0)
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, PEAK_FP32_FLOPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    ok = row["finite_fp32"] and row["rel_err_fp32"] <= TOL_FP32 and row["lse_rel_err_fp32"] <= TOL_FP32
    return row, ok


def _zoo_flash_bwd_case(name, bq, n, d, dev, iters, latent_weight):
    """K3 at a latent-zoo shape in fp32 (its scalar path), 4 heads, from
    K1's own o and lse under the exact running max; times in fp32 beside
    the backward of fp32 SDPA through autograd."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops.attention import _plain_flash_backward, flash_attention, flash_attention_bwd

    h, scale = 4, 1.0 / math.sqrt(d)
    g = torch.Generator(device=dev).manual_seed(bq * 7919 + n * 31 + d + 6)
    q = torch.randn(bq, n, 3 * h * d, generator=g, device=dev)[..., : h * d].unflatten(-1, (h, d))
    k, v, do = (torch.randn(bq, n, h, d, generator=g, device=dev) for _ in range(3))
    o, lse = flash_attention(q, k, v, scale=scale, static_max=0.0, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, do, lse, scale=scale)
    want = _plain_flash_backward(q, k, v, o, do, lse, 1, scale)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    row = {"name": name, "bq": bq, "bkv": bq, "kv_repeat": 1, "n": n, "d": d, "heads": h, "static_max": 0.0,
           "dtype": "fp32", "launches_per_step": 0, "launches_per_latent_run": latent_weight,
           "rel_err_fp32": max(errs), "rel_err_fp32_dq_dk_dv": errs,
           "abs_err_fp32": max(abs_err(a, b) for a, b in zip(got, want)),
           "finite_fp32": all(bool(torch.isfinite(a).all()) for a in got)}
    row["ms"] = device_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, scale=scale), iters)
    row["plain_ms"] = device_ms(lambda: _plain_flash_backward(q, k, v, o, do, lse, 1, scale), 3)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)
    row["library_ms"] = device_ms(
        lambda: torch.autograd.grad(out, (qs, ks, vs), do.transpose(1, 2), retain_graph=True), iters)
    flops = 10.0 * bq * h * n * n * d
    nbytes = 4.0 * h * d * n * 5 * bq + 4.0 * bq * h * n + 4.0 * h * d * n * 3 * bq
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, PEAK_FP32_FLOPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row, row["finite_fp32"] and row["rel_err_fp32"] <= TOL_FP32


def _temporal_case(name, b, fq, f, s, c, dev, iters, weight, forced=False, step_weight=0,
                   other_weights=None, heads=8):
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

    d = c // heads
    g = torch.Generator(device=dev).manual_seed(b * 104729 + s * 13 + c + f)
    q32 = torch.randn(b, fq, s, c, generator=g, device=dev)
    k32 = torch.randn(b, f, s, c, generator=g, device=dev)
    v32 = torch.randn(b, f, s, c, generator=g, device=dev)
    row = {"name": name, "b": b, "fq": fq, "f": f, "s": s, "c": c, "heads": heads,
           "launches_per_eval": weight, "launches_per_step": step_weight, **(other_weights or {})}
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


def _int8_case(name, m, k, n, dev, iters, weight=0, eval_weight=0, dequant=False, other_weights=None):
    """One K7 shape: the int32 result equal to the exact product (a float64
    matmul holds these sums exactly) with the weights in the K-major layout
    the kernel reads (as the serving path's quantised weights are stored)
    and in row-major storage (packed per call); then times: the kernel, that
    plain version and ``torch._int_mm`` in both layouts (the library
    yardstick; the faster one is ``library_ms``; it needs M > 16 and K, N
    multiples of 8, else null).
    ``dequant`` also checks and times the dequantising epilogue (bf16 out,
    as the int8 downsamplers run it) against its plain version.
    ``other_weights`` adds launch weights on other paths."""
    from i2v_adapter_tpu_torch.ops.profile_int8_dense import dequantize, int8_matmul, int8_matmul_plain

    g = torch.Generator(device=dev).manual_seed(m + 7 * k + 13 * n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    wq_km = wq.t().contiguous().t()
    want = int8_matmul_plain(xq, wq)
    got, got_rm = int8_matmul(xq, wq_km), int8_matmul(xq, wq)
    diff = max(float((a.double() - want.double()).abs().max()) for a in (got, got_rm))
    row = {"name": name, "m": m, "k": k, "n": n, "launches_per_tool_run": weight,
           "launches_per_eval": eval_weight, **(other_weights or {}), "abs_err_int32": diff,
           "equal": bool(torch.equal(got, want) and torch.equal(got_rm, want))}
    row["ms"] = device_ms(lambda: int8_matmul(xq, wq_km), iters)
    row["rowmajor_ms"] = device_ms(lambda: int8_matmul(xq, wq), iters)
    row["plain_ms"] = device_ms(lambda: int8_matmul_plain(xq, wq), 2)
    ok_shape = m > 16 and k % 8 == 0 and n % 8 == 0
    row["int_mm_ms"] = device_ms(lambda: torch._int_mm(xq, wq), iters) if ok_shape else None
    row["int_mm_kmajor_ms"] = device_ms(lambda: torch._int_mm(xq, wq_km), iters) if ok_shape else None
    row["library_ms"] = min(row["int_mm_ms"], row["int_mm_kmajor_ms"]) if ok_shape else None
    row["bound_ms"], row["bound_by"] = bound_ms(2.0 * m * k * n, m * k + k * n + 4.0 * m * n,
                                                PEAK_INT8_OPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    ok = row["equal"]
    if dequant:
        xs = torch.rand((), generator=g, device=dev) * 0.01 + 1e-3
        ws = torch.rand(n, generator=g, device=dev) * 0.01 + 1e-3
        bias = torch.randn(n, generator=g, device=dev)
        kw = dict(scale=xs, col_scale=ws, bias=bias, out_dtype=torch.bfloat16)
        y = int8_matmul(xq, wq_km, **kw).float()
        y_want = dequantize(want, xs, ws, bias, torch.bfloat16).float()
        # the same fp32 operations in the same order, one rounding to bf16
        row["dequant_abs_err"] = abs_err(y, y_want)
        row["dequant_within_bf16_rounding"] = bool(((y - y_want).abs() <= y_want.abs() * 2.0 ** -8).all())
        row["dequant_ms"] = device_ms(lambda: int8_matmul(xq, wq_km, **kw), iters)
        row["dequant_bound_ms"] = bound_ms(2.0 * m * k * n, m * k + k * n + 2.0 * m * n, PEAK_INT8_OPS)[0]
        ok = ok and row["dequant_within_bf16_rounding"]
    return row, ok


def _int8_conv_case(name, b, h, w, c, co, dev, iters, clip_weight, eval_weight=0, other_weights=None):
    """One int8 3x3 conv site, its weights a bf16 OIHW parameter as the
    serving pipeline stores them: the kernel's int32 sums equal to the plain
    version's (exact float64 products) from the same quantiser, its bf16
    dequantised output within a bf16 rounding of the plain dequantisation;
    then times: the kernel, the whole ``int8_conv`` op as the models run it
    (abs-max and kernel; the weights quantised once per load), the plain
    version, and the exact path's bf16 cuDNN
    conv at the same site (context: no PyTorch call computes an int8 conv,
    so ``library_ms`` is null).  ``other_weights`` adds launch weights on
    other paths."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops import int8 as I8

    g = torch.Generator(device=dev).manual_seed(b * 131 + h * 17 + w + c * 3 + co + 5)
    x = (torch.randn(b, h, w, c, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
    param = (torch.randn(co, c, 3, 3, generator=g, device=dev) / math.sqrt(9 * c)).to(torch.bfloat16)
    kernel = param.permute(2, 3, 1, 0)  # the HWIO view the models pass
    bias = (torch.randn(co, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    wq, ws = I8.quantize_weight(kernel)
    xs = I8.activation_scale(x)
    got32 = I8.int8_conv3x3_kernel(x, wq, xs, ws, bias, out_dtype=torch.int32)
    want32 = I8.int8_conv_int32_plain(I8.quantize_activation(x, xs), wq)
    got = I8.int8_conv3x3_kernel(x, wq, xs, ws, bias).float()
    want = I8.dequantize(want32, xs, ws, bias, torch.bfloat16).float()
    row = {"name": name, "b": b, "h": h, "w": w, "c": c, "cout": co,
           "launches_per_clip": clip_weight, "launches_per_eval": eval_weight, **(other_weights or {}),
           "equal_int32": bool(torch.equal(got32, want32)),
           "abs_err_int32": float((got32.double() - want32.double()).abs().max()),
           "abs_err": abs_err(got, want),
           "within_bf16_rounding": bool(((got - want).abs() <= want.abs() * 2.0 ** -8).all())}
    del got32, want32, got, want
    row["ms"] = device_ms(lambda: I8.int8_conv3x3_kernel(x, wq, xs, ws, bias), iters)
    weight = torch.nn.Parameter(param, requires_grad=False)  # a model's parameter: quantised once
    I8.prepare_weights([weight])
    row["op_ms"] = device_ms(lambda: I8.int8_conv(x, weight.permute(2, 3, 1, 0), bias), iters)
    row["plain_ms"] = device_ms(lambda: I8.int8_conv_plain(x, kernel, bias), 1)
    row["cudnn_bf16_ms"] = device_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), param, bias, padding=1), iters)
    row["library_ms"] = None
    ops = 2.0 * b * h * w * 9 * c * co
    nbytes = 2.0 * b * h * w * (c + co) + 9.0 * c * co + 8.0 * co
    row["bound_ms"], row["bound_by"] = bound_ms(ops, nbytes, PEAK_INT8_OPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row, row["equal_int32"] and row["within_bf16_rounding"]


def bf16_ulps(got: torch.Tensor, want: torch.Tensor, floor: float = 2.0 ** -12) -> float:
    """The largest |got - want| in bf16 ulps of ``want``, each ulp taken at
    least at ``floor`` of max |want|: a GroupNorm output near 0 differs by
    the statistics' fp32 rounding, which is absolute, not relative to it."""
    got, want = got.float(), want.float()
    mag = torch.clamp_min(want.abs(), float(want.abs().max()) * floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / ulp).max())


# GroupNorm sites: (name, samples, positions, channels, groups, dtype, eps,
# the resnets' SiLU and abs-max).  A 512 px, 16-frame CFG clip's in bf16 with
# 32 groups; the latent zoo's samplers (CFG-doubled 32x32 latents, 16 frames
# for SimpleUNet3D, its time stack over (F, H, W) per clip) with 8 groups and
# the dome's (8 images of 64x64) with 1, in fp32
GROUP_NORM_CASES = [
    ("unet resnet H64 C320", 32, 4096, 320, 32, torch.bfloat16, 1e-5, True),
    ("unet transformer H64 C320", 32, 4096, 320, 32, torch.bfloat16, 1e-6, False),
    ("motion H64 C320", 2, 16 * 4096, 320, 32, torch.bfloat16, 1e-6, False),
    ("unet resnet H32 C640", 32, 1024, 640, 32, torch.bfloat16, 1e-5, True),
    ("unet resnet H16 C2560", 32, 256, 2560, 32, torch.bfloat16, 1e-5, True),
    ("unet resnet H8 C1280", 32, 64, 1280, 32, torch.bfloat16, 1e-5, True),
    ("motion H8 C1280", 2, 16 * 64, 1280, 32, torch.bfloat16, 1e-6, False),
    ("svd temporal resnet clip 72x128 F25 C320", 2, 25 * 72 * 128, 320, 32, torch.bfloat16, 1e-6, True),
    ("decoder H512 C128", 16, 512 * 512, 128, 32, torch.bfloat16, 1e-6, True),
    ("decoder H256 C256", 16, 256 * 256, 256, 32, torch.bfloat16, 1e-6, True),
    ("zoo image H32 C64", 2, 1024, 64, 8, torch.float32, 1e-6, False),
    ("zoo image up H32 C192", 2, 1024, 192, 8, torch.float32, 1e-6, False),
    ("zoo video H32 C64", 32, 1024, 64, 8, torch.float32, 1e-6, False),
    ("zoo video time stack H16 C128", 2, 16 * 256, 128, 8, torch.float32, 1e-6, False),
    ("zoo video up H8 C512", 32, 64, 512, 8, torch.float32, 1e-6, False),
    ("dome H64 C64", 8, 4096, 64, 1, torch.float32, 1e-6, False),
    ("dome H16 C256", 8, 256, 256, 1, torch.float32, 1e-6, False),
    ("dome H8 C512", 8, 64, 512, 1, torch.float32, 1e-6, False),
]


def _group_norm_case(name, n, rows, c, groups, dtype, eps, silu, dev, iters):
    """One GroupNorm site: the kernel (``ops.norms.group_norm_fused``) against
    the composition (``ops.norms.group_norm_plain``) on the same inputs:
    within 2 bf16 ulps in bf16 (``bf16_ulps``), within 4e-6 of max |out| in
    fp32 (the statistics' summation order); with ``silu`` its SiLU equal bit
    for bit to ``F.silu`` of its own plain output and its abs-max to ``max
    |out|`` (so the int8 scale is ``activation_scale``'s).  Times: the
    kernel (with SiLU and abs-max where ``silu``, as the resnets call it),
    the sequence it replaces (the composition, then ``F.silu`` and the int8
    conv's ``aminmax`` scale), and ``F.group_norm`` on the channels-last
    NCHW view (``library_ms``).  The bound: the function's bytes, x read
    once and out written once; ``two_pass_bound_ms``: the kernel's design,
    which reads x twice."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops import int8 as I8
    from i2v_adapter_tpu_torch.ops import norms as N

    g = torch.Generator(device=dev).manual_seed(n * 7 + rows + c + groups)
    spread = 0.5 + 2 * torch.rand(c, generator=g, device=dev)
    x = (torch.randn(n, rows, c, generator=g, device=dev) * spread
         + torch.randn(c, generator=g, device=dev)).to(dtype)
    w = (1 + 0.2 * torch.randn(c, generator=g, device=dev)).to(dtype)
    b = (0.2 * torch.randn(c, generator=g, device=dev)).to(dtype)
    got = N.group_norm_fused(x, groups, eps, w, b)
    want = N.group_norm_plain(x, groups, eps, w, b)
    row = {"name": name, "n": n, "rows": rows, "c": c, "groups": groups, "dtype": str(dtype), "eps": eps,
           "silu_absmax": silu, "abs_err": abs_err(got, want)}
    if dtype == torch.bfloat16:
        row["ulps"] = bf16_ulps(got, want)
        ok = row["ulps"] <= 2
    else:
        row["rel_err"] = row["abs_err"] / float(want.abs().max())
        ok = row["rel_err"] <= 4e-6
    if silu:
        act, peak = N.group_norm_fused(x, groups, eps, w, b, silu=True, absmax=True)
        row["silu_equal"] = bool(torch.equal(act, F.silu(got)))
        row["absmax_equal"] = bool(torch.equal(peak, act.float().abs().amax())
                                   and torch.equal(I8.absmax_scale(peak), I8.activation_scale(act)))
        ok = ok and row["silu_equal"] and row["absmax_equal"]
    del got, want
    row["ms"] = device_ms(lambda: N.group_norm_fused(x, groups, eps, w, b, silu=silu, absmax=silu), iters)
    if silu:
        row["plain_ms"] = device_ms(lambda: I8.activation_scale(N.group_norm_plain(x, groups, eps, w, b, True)),
                                    iters)
    else:
        row["plain_ms"] = device_ms(lambda: N.group_norm_plain(x, groups, eps, w, b), iters)
    nchw = x.view(n, rows, 1, c).permute(0, 3, 1, 2)
    row["library_ms"] = device_ms(lambda: F.group_norm(nchw, groups, w, b, eps), iters)
    row["bound_ms"], row["bound_by"] = bound_ms(0.0, 2.0 * x.numel() * x.element_size(), PEAK_BF16_FLOPS)
    row["two_pass_bound_ms"] = bound_ms(0.0, 3.0 * x.numel() * x.element_size(), PEAK_BF16_FLOPS)[0]
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row, ok


def _quantize_weights_case(name, shapes, dev, iters, load_weight):
    """The grouped weight quantiser on bf16 OIHW parameters of ``shapes``
    ((C, Cout) per int8 site, as the serving pipeline stores them), all in
    one launch: each site's int8 weights and fp32 scales equal to the plain
    version's, bit for bit; then times of the one launch and of the plain
    version over every site; no single PyTorch call computes it
    (``library_ms`` null).  The bound: each parameter read once (bf16), the
    int8 weights and the scales written once."""
    from i2v_adapter_tpu_torch.ops import int8 as I8

    g = torch.Generator(device=dev).manual_seed(len(shapes))
    kernels = [(torch.randn(co, c, 3, 3, generator=g, device=dev) / math.sqrt(9 * c)).to(torch.bfloat16)
               .permute(2, 3, 1, 0) for c, co in shapes]
    got = I8.quantize_weights(kernels)
    unequal = [i for i, (k, (wq, ws)) in enumerate(zip(kernels, got))
               if not (lambda p: torch.equal(wq, p[0]) and torch.equal(ws, p[1]))(I8.quantize_weight_plain(k))]
    values = sum(9 * c * co for c, co in shapes)
    rows = sum(co for _, co in shapes)
    row = {"name": name, "sites": len(shapes), "output_channels": rows, "values": values,
           "launches_per_load": load_weight, "launches_per_clip": 0, "sites_unequal": unequal,
           "equal": not unequal, "abs_err_int8": 0.0 if not unequal else float("nan")}
    del got
    row["ms"] = device_ms(lambda: I8.quantize_weights(kernels), iters)
    row["plain_ms"] = device_ms(lambda: [I8.quantize_weight_plain(k) for k in kernels], 1)
    row["library_ms"] = None
    row["bound_ms"], row["bound_by"] = bound_ms(float(values), 3.0 * values + 4.0 * rows, PEAK_INT8_OPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row, row["equal"]


def int8_site_shapes(model_cfg) -> list:
    """``(C, Cout)`` of every int8 site of the serving default (the UNet's
    resnet, down- and upsample convs, the VAE decoder's), in module order,
    from the models built on the meta device."""
    from i2v_adapter_tpu_torch.models import AutoencoderKL, VideoUNet
    from i2v_adapter_tpu_torch.models.layers import int8_sites

    with torch.device("meta"):
        unet = VideoUNet(model_cfg.unet.replace(int8_conv=True), device="meta")
        vae = AutoencoderKL(model_cfg.vae.replace(int8_decode=True), device="meta")
    return [(m.weight.shape[1], m.weight.shape[0]) for m in int8_sites(unet, vae)]


# the tool's shapes that the smoke run times (one per UNet level)
INT8_TOOL_SHAPES = (0, 6, 12)


# (name, bq, bkv, n, d, heads, launches per meshed evaluation)
MESH_FLASH_CASES = (
    ("mesh (2,1,2) adapter N4096 D40 rep8", 8, 1, 4096, 40, 8, 5),
    ("mesh (2,1,2) adapter N1024 D80 rep8", 8, 1, 1024, 80, 8, 5),
    ("mesh (2,1,2) adapter N256 D160 rep8", 8, 1, 256, 160, 8, 5),
    ("mesh (1,1,4) adapter N4096 D40 rep4", 8, 2, 4096, 40, 8, 5),
    ("mesh (1,1,4) adapter N1024 D80 rep4", 8, 2, 1024, 80, 8, 5),
    ("mesh (1,1,4) adapter N256 D160 rep4", 8, 2, 256, 160, 8, 5),
    ("mesh (2,2,1) attn1 N4096 D40 H4", 16, 16, 4096, 40, 4, 5),
    ("mesh (2,2,1) adapter N4096 D40 H4 rep16", 16, 1, 4096, 40, 4, 5),
    ("mesh (2,2,1) attn1 N1024 D80 H4", 16, 16, 1024, 80, 4, 5),
    ("mesh (2,2,1) attn1 N256 D160 H4", 16, 16, 256, 160, 4, 5),
)
# (name, b, frames, local S, C, heads, launches per meshed evaluation)
MESH_TEMPORAL_CASES = (
    ("mesh (2,1,2) motion S2048 C320", 1, 16, 2048, 320, 8, 10),
    ("mesh (2,1,2) motion S512 C640", 1, 16, 512, 640, 8, 10),
    ("mesh (2,1,2) motion S128 C1280", 1, 16, 128, 1280, 8, 10),
    ("mesh (1,1,4) motion S1024 C320", 2, 16, 1024, 320, 8, 10),
    ("mesh (1,1,4) motion S256 C640", 2, 16, 256, 640, 8, 10),
    ("mesh (2,2,1) motion S4096 C160 H4", 1, 16, 4096, 160, 4, 10),
    ("mesh (2,2,1) motion S1024 C320 H4", 1, 16, 1024, 320, 4, 10),
    ("mesh (2,2,1) motion S256 C640 H4", 1, 16, 256, 640, 4, 10),
)

# Stable Video Diffusion img2vid-xt's shapes (1024x576: 72x128 latents, 25
# frames, CFG: 50 frame-evaluations, head dim 64), weighted by launches per
# SVD UNet evaluation: K1 at each level's spatial self-attention (5
# transformers a level, 1 in the mid block) and K2 over the 25 frames of
# each position; the clip-wide GroupNorm of the temporal resnets at level 0
# is GROUP_NORM_CASES' "svd" row (10 a evaluation).
# (name, bq, n, heads, launches per SVD evaluation)
SVD_FLASH_CASES = (
    ("svd attn1 N9216 D64", 50, 9216, 5, 5),
    ("svd attn1 N2304 D64", 50, 2304, 10, 5),
    ("svd attn1 N576 D64", 50, 576, 20, 5),
    ("svd mid attn1 N144 D64", 50, 144, 20, 1),
)
# (name, S, C, heads, launches per SVD evaluation); b = 2 clips, F = 25
SVD_TEMPORAL_CASES = (
    ("svd temporal F25 S9216 C320", 9216, 320, 5, 5),
    ("svd temporal F25 S2304 C640", 2304, 640, 10, 5),
    ("svd temporal F25 S576 C1280", 576, 1280, 20, 5),
    ("svd mid temporal F25 S144 C1280", 144, 1280, 20, 1),
)

# the shapes each rank gives K3 and K2 in the mesh_train phase's 4-card
# train steps (config 4 at 256 px, 2 clips a data x fsdp way; the 512 px
# motion finetune at 1 clip a way), weighted by launches per meshed train
# step: K3 at the adapter's local kv_repeat (16 frames over seq 2: 8; over
# seq 4: 4, a shape no 4-card case takes) and with the heads split over
# tensor; K2 token-sharded (S / seq, C / tensor), forward and recompute.
# (name, bq, bkv, n, d, heads, launches per meshed train step)
MESH_TRAIN_BWD_CASES = (
    ("mesh train (2,1,1,2) attn1 N1024 D40", 16, 16, 1024, 40, 8, 4),
    ("mesh train (2,1,1,2) adapter N1024 D40 rep8", 16, 2, 1024, 40, 8, 5),
    ("mesh train (2,1,2,1) attn1 N1024 D40 H4", 32, 32, 1024, 40, 4, 4),
    ("mesh train (2,1,2,1) adapter N1024 D40 H4 rep16", 32, 2, 1024, 40, 4, 5),
    ("mesh train 512px (1,2,1,2) attn1 N4096 D40", 8, 8, 4096, 40, 8, 4),
    ("mesh train 512px (1,2,1,2) adapter N4096 D40 rep8", 8, 1, 4096, 40, 8, 5),
    ("mesh train 512px (1,2,1,2) attn1 N1024 D80", 8, 8, 1024, 80, 8, 5),
    ("mesh train 512px (1,2,1,2) adapter N1024 D80 rep8", 8, 1, 1024, 80, 8, 5),
    ("mesh train seq 4 adapter N1024 D40 rep4", 8, 2, 1024, 40, 8, 0),
)
# (name, b, frames, local S, C, heads, launches per meshed train step)
MESH_TRAIN_TEMPORAL_CASES = (
    ("mesh train (2,1,1,2) motion S512 C320", 2, 16, 512, 320, 8, 20),
    ("mesh train (2,1,1,2) motion S128 C640", 2, 16, 128, 640, 8, 20),
    ("mesh train (2,1,2,1) motion S1024 C160 H4", 2, 16, 1024, 160, 4, 20),
    ("mesh train (2,1,2,1) motion S256 C320 H4", 2, 16, 256, 320, 4, 20),
    ("mesh train 512px (1,2,1,2) motion S2048 C320", 1, 16, 2048, 320, 8, 20),
    ("mesh train 512px (1,2,1,2) motion S512 C640", 1, 16, 512, 640, 8, 20),
    ("mesh train 512px (1,2,1,2) motion S128 C1280", 1, 16, 128, 1280, 8, 20),
    ("mesh train seq 4 motion S256 C320", 2, 16, 256, 320, 8, 0),
)


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
    # the full_face IP attention (257 keys) at every level of a 512 px,
    # 16-frame CFG evaluation, weighted by its launches per full_face
    # evaluation; and the cross-frame attention of temporal tiling's
    # anchored windows (17 frames, kv_repeat 17; a CFG-doubled window is
    # Bq = 34), weighted by its launches per window evaluation of a
    # 48-frame clip (3 of its 4 windows are anchored)
    ip_cases = [
        ("ip N4096 K257 D40", 32, 32, 4096, 40, 5),
        ("ip N1024 K257 D80", 32, 32, 1024, 80, 5),
        ("ip N256 K257 D160", 32, 32, 256, 160, 5),
        ("ip N64 K257 D160", 32, 32, 64, 160, 1),
    ]
    window_cases = [("window adapter N4096 D40 rep17", 34, 2, 4096, 40, 5),
                    ("window adapter N1024 D80 rep17", 34, 2, 1024, 80, 5),
                    ("window adapter N256 D160 rep17", 34, 2, 256, 160, 5)]
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
    ]
    # the anchored windows' motion modules: F = 17 (10 launches per window
    # evaluation at S = 4096 and 1024 each)
    window_temporal_cases = [
        ("window motion F17 S4096 C320", 2, 17, 17, 4096, 320, 10),
        ("window motion F17 S1024 C640", 2, 17, 17, 1024, 640, 10),
        ("window motion F17 S256 C1280", 2, 17, 17, 256, 1280, 10),
    ]
    # K2 at the 256 px training step: 20 launches at each site per step
    # (10 motion attentions, forward and the checkpointed recompute)
    train_temporal_cases = [
        ("train motion S1024 C320", 2, 16, 16, 1024, 320, 20),
        ("train motion S256 C640", 2, 16, 16, 256, 640, 20),
    ]
    # K1 on (B, H, N, D) storage (the reference's K5) at the serving sites
    row_major_cases = [c for c in flash_cases if c[-1] > 0]
    # K2 forced below 128 tokens (the reference's K6): the 8x8 level, where
    # 'auto' takes the einsum; 12 launches per evaluation when forced
    forced_cases = [
        ("forced S64 C1280", 2, 16, 16, 64, 1280, 12),
        ("forced Fq8<F16 S64 C1280", 2, 8, 16, 64, 1280, 0),
    ]
    from i2v_adapter_tpu_torch.config import I2VModelConfig, VideoUNetConfig
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
    add("int8_matmul", _int8_case("ragged dequant 1000x48x36", 1000, 48, 36, dev, 5, dequant=True),
        "int8 ")
    # K7 on the serving path: the int8 downsamplers' im2col products at 512 px
    # with CFG (32 frame-evals), M = 32*(H/2)^2, K = 9*C, N = Cout
    # and at the driver's 256 px validation clip (the same CFG batch),
    # weighted by launches per validation clip
    serving = I2VModelConfig().replace(unet=I2VModelConfig().unet.replace(int8_conv=True))
    val_latent, val_steps = DRIVER_RESOLUTION // 8, clip_denoise_steps(VALIDATION_STEPS)
    downs = {}
    for latent, per_eval, per_val in ((64, 1, 0), (val_latent, 0, val_steps)):
        for h, c, co, cnt in int8_downsample_sites(serving.unet, latent):
            w = downs.setdefault((32 * (h // 2) ** 2, 9 * c, co), [0, 0, h])
            w[0], w[1] = w[0] + per_eval * cnt, w[1] + per_val * cnt
    for (m, k, n), (per_eval, per_val, h) in downs.items():
        add("int8_matmul", _int8_case(f"downsample H{h} {m}x{k}x{n}", m, k, n, dev, 5, eval_weight=per_eval,
                                      dequant=True, other_weights={"launches_per_validation_clip": per_val}),
            "int8 ")
    # the int8 3x3 conv at every site of a 512 px, 16-frame CFG clip and of
    # the driver's 256 px validation clip: the UNet's (32 frame-evals, once
    # per denoise step) and the VAE decoder's (16 frames, once per clip),
    # weighted by launches per clip of each
    steps = clip_denoise_steps()
    sites = {}
    for latent, clip_steps, key in ((64, steps, 0), (val_latent, val_steps, 2)):
        for h, c, co, cnt in int8_unet_sites(serving.unet, latent):
            w = sites.setdefault((32, h, c, co), [0, 0, 0])
            w[key] += clip_steps * cnt
            w[1] += cnt if key == 0 else 0
        for h, c, co, cnt in int8_decoder_sites(serving.vae, latent):
            sites.setdefault((16, h, c, co), [0, 0, 0])[key] += cnt
    for (b, h, c, co), (clip, per_eval, per_val) in sites.items():
        part = "unet" if b == 32 else "decoder"
        add("int8_conv3x3_kernel", _int8_conv_case(
            f"{part} H{h} {c}->{co}", b, h, h, c, co, dev, 3 if h >= 256 else 5, clip, per_eval,
            other_weights={"launches_per_validation_clip": per_val}), "int8 conv ")
    # the grouped weight quantiser: every int8 site of the serving default in
    # one launch, once per load (none per clip)
    add("quantize_weights", _quantize_weights_case("every int8 site of I2VModelConfig()",
                                                   int8_site_shapes(serving), dev, 5, 1), "int8 weights ")
    add("int8_conv3x3_kernel", _int8_conv_case("ragged 2x12x8 144->264", 2, 12, 8, 144, 264, dev, 5, 0),
        "int8 conv ")
    add("int8_conv3x3_kernel", _int8_conv_case("wide strips 1x6x300 64->136", 1, 6, 300, 64, 136, dev,
                                               5, 0), "int8 conv ")
    for case in GROUP_NORM_CASES:
        add("group_norm_fused", _group_norm_case(*case, dev=dev, iters=10), "group norm ")
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
    for name, bq, bkv, n, d, w in ip_cases:
        row, ok = _flash_case(name, bq, bkv, n, d, 64.0, dev, 5, 0, nk=257,
                              other_weights={"launches_per_full_face_eval": w})
        rows["flash_attention"].append(row)
        failed += [] if ok else [row["name"]]
    for name, bq, bkv, n, d, w in window_cases:
        row, ok = _flash_case(name, bq, bkv, n, d, 64.0, dev, 5, 0,
                              other_weights={"launches_per_window_eval": w})
        rows["flash_attention"].append(row)
        failed += [] if ok else [row["name"]]
    for case in bwd_cases:
        row, ok = _flash_bwd_case(*case[:-1], dev=dev, iters=5, weight=case[-1])
        rows["flash_attention_bwd"].append(row)
        failed += [] if ok else ["bwd " + row["name"]]
    # the latent zoo's shapes (fp32, 4 heads), weighted by their launches in
    # one latent phase: K1 at the video UNet's 256-token sites (2 clips x 16
    # frames; its sampler's CFG batch of 16 frames) and at the image UNet's
    # 1024- and 256-token sites (batch 8), the image_only steps' and the 2-D
    # sampler's 256-token sites (batch 2); K3 at the 1024-token sites
    for (kernel, bq, n, d), count in latent_run_launches(LATENT_ZOO, 1 + TRAIN_STEPS,
                                                           LATENT_SAMPLE_TIMESTEPS).items():
        if kernel == "flash_attention":
            add("flash_attention", _zoo_flash_case(f"zoo fp32 B{bq} N{n} D{d}", bq, n, d, dev, 20, count))
        else:
            add("flash_attention_bwd", _zoo_flash_bwd_case(f"zoo fp32 B{bq} N{n} D{d}", bq, n, d, dev, 20, count),
                "bwd ")
    for case in temporal_cases:
        row, ok = _temporal_case(*case[:-1], dev=dev, iters=20, weight=case[-1])
        rows["temporal_attention_cs"].append(row)
        failed += [] if ok else [row["name"]]
    for case in train_temporal_cases:
        row, ok = _temporal_case(*case[:-1], dev=dev, iters=20, weight=0, step_weight=case[-1])
        rows["temporal_attention_cs"].append(row)
        failed += [] if ok else [row["name"]]
    for case in window_temporal_cases:
        row, ok = _temporal_case(*case[:-1], dev=dev, iters=20, weight=0,
                                 other_weights={"launches_per_window_eval": case[-1]})
        rows["temporal_attention_cs"].append(row)
        failed += [] if ok else [row["name"]]
    # the shapes each rank gives K1 and K2 over the 4-card meshes of the
    # mesh phase (512 px, 16 frames, CFG), weighted by launches per meshed
    # evaluation: the cross-frame adapter with the local kv_repeat (8 at
    # (2,1,2): one CFG half x 8 frames; 4 at (1,1,4): 2 halves x 4 frames),
    # 4 heads at tensor 2 ((2,2,1): one half x 16 frames), and K2
    # token-sharded (S / seq; a local S under 128 takes the plain path)
    for name, bq, bkv, n, d, heads, w in MESH_FLASH_CASES:
        row, ok = _flash_case(name, bq, bkv, n, d, 64.0, dev, 5, 0, heads=heads,
                              other_weights={"launches_per_mesh_eval": w})
        rows["flash_attention"].append(row)
        failed += [] if ok else [row["name"]]
    for name, b, f, seq_s, c, heads, w in MESH_TEMPORAL_CASES:
        row, ok = _temporal_case(name, b, f, f, seq_s, c, dev, 10, 0, heads=heads,
                                 other_weights={"launches_per_mesh_eval": w})
        rows["temporal_attention_cs"].append(row)
        failed += [] if ok else [row["name"]]
    for name, bq, bkv, n, d, heads, w in MESH_TRAIN_BWD_CASES:
        row, ok = _flash_bwd_case(name, bq, bkv, n, d, dev, 5, 0, heads=heads,
                                  other_weights={"launches_per_mesh_train_step": w})
        rows["flash_attention_bwd"].append(row)
        failed += [] if ok else ["bwd " + row["name"]]
    for name, b, f, seq_s, c, heads, w in MESH_TRAIN_TEMPORAL_CASES:
        row, ok = _temporal_case(name, b, f, f, seq_s, c, dev, 10, 0, heads=heads,
                                 other_weights={"launches_per_mesh_train_step": w})
        rows["temporal_attention_cs"].append(row)
        failed += [] if ok else [row["name"]]
    for name, bq, n, heads, w in SVD_FLASH_CASES:
        row, ok = _flash_case(name, bq, bq, n, 64, 0.0, dev, 5, 0, heads=heads,
                              other_weights={"launches_per_svd_eval": w})
        rows["flash_attention"].append(row)
        failed += [] if ok else [row["name"]]
    for name, seq_s, c, heads, w in SVD_TEMPORAL_CASES:
        row, ok = _temporal_case(name, 2, 25, 25, seq_s, c, dev, 10, 0, heads=heads,
                                 other_weights={"launches_per_svd_eval": w})
        rows["temporal_attention_cs"].append(row)
        failed += [] if ok else [row["name"]]
    emit({"phase": "kernels", "tol_fp32": TOL_FP32, "tol_bf16": TOL_BF16,
          "timing": "bf16, CUDA events, warm-up + mean of many launches, L2 not flushed",
          "cases": rows, "failed": failed})
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    return rows


@contextlib.contextmanager
def plain_int8_convs():
    """The models' int8 convs through the plain version (``ops.int8.
    int8_conv_plain``: exact int32 sums as float64 products) instead of the
    kernels, for the kernels-vs-plain comparison of a whole evaluation."""
    from i2v_adapter_tpu_torch.models import layers
    from i2v_adapter_tpu_torch.ops.int8 import int8_conv_plain

    real = layers.int8_conv
    layers.int8_conv = int8_conv_plain
    try:
        yield
    finally:
        layers.int8_conv = real


def phase_unet(model_cfg, dev, dtype, rehearse: bool):
    """One full-width UNet evaluation (64x64 latents, 2 frames, CFG-doubled,
    cross-frame + IP) with the kernels and with plain attention; then the
    same weights in a model built with ``conv_impl='pallas'`` (every resnet
    stage through K4) and with the temporal kernel forced at every motion
    module, each against the ``'auto'`` result."""
    from i2v_adapter_tpu_torch.models import VideoUNet
    from i2v_adapter_tpu_torch.models.layers import prepare_int8
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
        # the serving default's int8 convs on the same weights (quantised
        # once, as a pipeline does when int8 is switched on): kernels, then
        # the plain int8 convs
        unet.set_int8(True)
        prepare_int8(unet)
        got_int8, int8_s, int8_counts = counted(unet)
        with plain_int8_convs():
            want_int8 = run(unet)
        unet.set_int8(False)
    db_int8 = psnr(got_int8.cpu().numpy(), want_int8.cpu().numpy())
    db_int8_exact = psnr(got_int8.cpu().numpy(), got.cpu().numpy())
    db = psnr(got.cpu().numpy(), want.cpu().numpy())
    db_fused = psnr(got_fused.cpu().numpy(), got.cpu().numpy())
    db_forced = psnr(got_forced.cpu().numpy(), got.cpu().numpy())
    flash, temporal_auto = launches_per_unet_eval(ucfg, lat, True)
    temporal_all = launches_per_unet_eval(ucfg, lat, True, temporal_min=0)[1]
    expected = expected_counts(flash_attention=flash, temporal_attention_cs=temporal_auto,
                               group_norm_fused=group_norms_per_unet_eval(ucfg, dtype=dtype))
    expected_fused = dict(expected, conv3x3_kernel=conv_launches_per_unet_eval(fused_cfg),
                          group_norm_fused=group_norms_per_unet_eval(fused_cfg, dtype=dtype))
    expected_forced = dict(expected, temporal_attention_cs=temporal_all)
    expected_int8 = dict(expected, **int8_launches(model_cfg, lat)["per_eval"])
    if rehearse:
        expected = expected_fused = expected_forced = expected_int8 = expected_counts()
    finite = all(bool(torch.isfinite(t).all()) for t in (got, got_fused, got_forced, got_int8))
    line = {"phase": "unet", "latent": lat, "frames": 2, "batch": 2, "dtype": str(dtype),
            "psnr_db_kernel_vs_plain": db, "first_eval_s": kernel_s, "finite": finite,
            "launches": counts, "expected_launches": expected,
            "conv_impl_pallas": {"psnr_db_vs_auto": db_fused, "first_eval_s": fused_s,
                                 "launches": fused_counts, "expected_launches": expected_fused},
            "temporal_kernel_forced": {"psnr_db_vs_auto": db_forced, "launches": forced_counts,
                                       "expected_launches": expected_forced},
            "int8_conv": {"psnr_db_kernels_vs_plain_int8": db_int8, "psnr_db_vs_exact_convs": db_int8_exact,
                          "first_eval_s": int8_s, "launches": int8_counts,
                          "expected_launches": expected_int8}}
    emit(line)
    if not finite or min(db, db_fused, db_forced, db_int8) <= PSNR_MIN:
        raise AssertionError(f"unet: finite={finite} psnr kernel vs plain {db}, "
                             f"conv_impl pallas vs auto {db_fused}, forced temporal vs auto {db_forced}, "
                             f"int8 kernels vs plain int8 {db_int8}")
    for name, have, want_counts in (("auto", counts, expected), ("pallas", fused_counts, expected_fused),
                                    ("forced temporal", forced_counts, expected_forced),
                                    ("int8", int8_counts, expected_int8)):
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
            conv3x3_kernel=evals * conv_launches_per_unet_eval(p.config.unet),
            group_norm_fused=sum(group_norms_per_request(p.config, len(r["timings"]["step_ms"])) for r in requests))
        if rehearse:
            expected = expected_counts()
        return requests, counts, expected

    if not rehearse:
        torch.cuda.reset_peak_memory_stats()
    requests, counts, expected = serve(pipe, (0, 1))
    fused_requests, fused_counts, fused_expected = serve(fused_pipe, (0,))
    n_steps = len(pipe.last_timings["step_ms"])
    int8_line, int8_counts = _serve_int8(model_cfg, pipe, image, requests[0], size, frames, steps,
                                         dtype, dev, rehearse)
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
    line["int8_serving_default"] = int8_line
    emit(line)
    for r in requests + fused_requests:
        if r["shape"] != want_shape or r["dtype"] != "uint8":
            raise AssertionError(f"pipeline output {r['shape']} {r['dtype']} != {want_shape} uint8")
    if counts != expected or fused_counts != fused_expected:
        raise AssertionError(f"pipeline launches {counts} != expected {expected}, or with "
                             f"conv_impl='pallas' {fused_counts} != {fused_expected}")
    if not line["seeds_differ"]:
        raise AssertionError("two seeds gave the same clip")
    if int8_line["failed"]:
        raise AssertionError(f"pipeline, serving default (int8): {int8_line['failed']}")
    return counts, fused_counts, int8_counts, pipe


def _serve_int8(model_cfg, pipe, image, exact, size, frames, steps, dtype, dev, rehearse: bool):
    """The serving default, ``PipelineConfig()`` with its int8 convs (the
    other settings as the exact requests), on the exact pipeline's weights:
    seed 0 once for its latents (``output_type='latent'``) and once decoded,
    the launch counts of each call set to 0 just before it.  The latent call
    gives the launches per denoise step, the difference the launches per
    decode; both are held to the config's."""
    from i2v_adapter_tpu_torch.config import PipelineConfig
    from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline

    pcfg = PipelineConfig(num_frames=frames, height=size, width=size, num_inference_steps=steps,
                          guidance_scale=7.5, blur_sigma=1.0, dtype="float32" if rehearse else "bfloat16")
    assert pcfg.int8_conv  # the serving default
    int8_pipe = I2VAdapterPipeline(
        model_cfg, {"unet": pipe.unet, "vae": pipe.vae, "text_encoder": pipe.text_encoder,
                    "image_encoder": pipe.image_encoder}, pipe.tokenizer, pcfg, device=dev)
    runs = {}
    try:
        for output_type in ("latent", "np"):
            reset_launch_counts()
            t0 = time.perf_counter()
            out = int8_pipe("a cat", condition_image=image, seed=0, output_type=output_type)
            runs[output_type] = {"seconds": time.perf_counter() - t0, "shape": list(out.shape),
                                 "dtype": str(out.dtype), "timings": int8_pipe.last_timings,
                                 "launches": launch_counts(), "out": out}
    finally:
        int8_pipe.enable_int8_conv(False)  # the shared modules back to exact convs
    latent = size // model_cfg.vae.spatial_scale_factor
    n_steps = len(runs["np"]["timings"]["step_ms"])
    derived = int8_launches(model_cfg, latent)
    per_step = {k: runs["latent"]["launches"][k] / n_steps for k in derived["per_eval"]}
    per_decode = {k: runs["np"]["launches"][k] - runs["latent"]["launches"][k] for k in derived["per_decode"]}
    want_step, want_decode = derived["per_eval"], derived["per_decode"]
    # the GroupNorm kernel: the latent call's steps and encode, the decode's
    group_norms = {"latent": runs["latent"]["launches"]["group_norm_fused"],
                   "decode": runs["np"]["launches"]["group_norm_fused"] - runs["latent"]["launches"]["group_norm_fused"]}
    want_group_norms = {"latent": group_norms_per_request(model_cfg, n_steps, decode_calls=0),
                        "decode": group_norms_per_vae_call(model_cfg.vae, "decoder")}
    if rehearse:
        want_step = want_decode = {k: 0 for k in derived["per_eval"]}
        want_group_norms = {k: 0 for k in group_norms}
    failed = []
    if per_step != {k: float(v) for k, v in want_step.items()}:
        failed.append(f"launches per step {per_step} != {want_step}")
    if per_decode != want_decode:
        failed.append(f"launches per decode {per_decode} != {want_decode}")
    if group_norms != want_group_norms:
        failed.append(f"GroupNorm kernel launches {group_norms} != {want_group_norms}")
    if runs["np"]["shape"] != [1, frames, size, size, 3] or runs["np"]["dtype"] != "uint8":
        failed.append(f"output {runs['np']['shape']} {runs['np']['dtype']}")
    if runs["latent"]["shape"] != [1, frames, latent, latent, model_cfg.unet.in_channels]:
        failed.append(f"latents {runs['latent']['shape']}")
    exact_t = exact["timings"]
    line = {
        "config": "PipelineConfig() defaults: int8_conv=True",
        "prep_ms": runs["np"]["timings"]["prep_ms"], "step_ms": runs["np"]["timings"]["step_ms"],
        "mean_step_ms": float(np.mean(runs["np"]["timings"]["step_ms"])),
        "decode_ms": runs["np"]["timings"]["decode_ms"],
        "exact_seed0": {"prep_ms": exact_t["prep_ms"], "mean_step_ms": float(np.mean(exact_t["step_ms"])),
                        "decode_ms": exact_t["decode_ms"]},
        "latent_call": {k: v for k, v in runs["latent"].items() if k != "out"},
        "launches_per_step": per_step, "launches_per_decode": per_decode,
        "expected_per_step": want_step, "expected_per_decode": want_decode,
        "group_norm_launches": group_norms, "expected_group_norm_launches": want_group_norms,
        "psnr_db_vs_exact_convs": psnr(runs["np"]["out"], exact["video"]),
        "finite_latents": bool(np.isfinite(runs["latent"]["out"]).all()),
        "failed": failed,
    }
    return line, runs["np"]["launches"]


def _scan_step_ms(step_ms, kinds, scan: bool) -> dict:
    """Step ms by step kind: under ``'scan'`` the kind's first step (eager),
    its second (capture, then the first replay: the card idles while the
    host captures) and the mean of its replays after that; under
    ``'stepwise'`` the mean of the kind's steps after its first."""
    out = {}
    for kind in dict.fromkeys(kinds):
        ms = [t for t, k in zip(step_ms, kinds) if k == kind]
        if scan:
            out[kind] = {"eager": ms[0], "capture_step": ms[1] if len(ms) > 1 else None,
                         "replay_mean": float(np.mean(ms[2:])) if len(ms) > 2 else None, "n": len(ms)}
        else:
            out[kind] = {"first": ms[0], "mean_after_first": float(np.mean(ms[1:])) if len(ms) > 1 else None,
                         "n": len(ms)}
    return out


def _synthetic_lora(unet, layout: str, seed: int) -> dict:
    """A full-width LoRA state dict of rank 4 over ``unet``'s module names in
    the diffusers paths: ``'peft'`` on every spatial attention's q, k, v and
    out projections (``lora_A`` / ``lora_B``), ``'kohya'`` on every resnet's
    two 3x3 convs (``lora_down`` 3x3, ``lora_up`` 1x1, ``alpha``: the int8
    sites)."""
    rank, g = 4, torch.Generator().manual_seed(seed)
    diffusers = lambda name: re.sub(r"(blocks|attentions|resnets)_(\d+)", r"\1.\2", name)  # noqa: E731
    sd = {}
    for name, m in unet.named_modules():
        if layout == "peft" and re.search(r"attentions_\d+\.transformer_blocks_\d+\.attn[12]\.(to_[qkv]|to_out)$",
                                          name):
            path = diffusers(name) + (".0" if name.endswith("to_out") else "")
            cout, cin = m.weight.shape
            sd[f"unet.{path}.lora_A.weight"] = (torch.randn(rank, cin, generator=g) / math.sqrt(cin)).numpy()
            sd[f"unet.{path}.lora_B.weight"] = (torch.randn(cout, rank, generator=g) * 0.05).numpy()
        elif layout == "kohya" and re.search(r"resnets_\d+\.conv[12]$", name):
            key = "lora_unet_" + diffusers(name).replace(".", "_")
            cout, cin = m.weight.shape[:2]
            sd[f"{key}.lora_down.weight"] = (torch.randn(rank, cin, 3, 3, generator=g) / math.sqrt(9 * cin)).numpy()
            sd[f"{key}.lora_up.weight"] = (torch.randn(cout, rank, 1, 1, generator=g) * 0.05).numpy()
            sd[f"{key}.alpha"] = np.array(float(rank), np.float32)
    return sd


def _kept_graph_check(name, serving, kw, output, hit, run, model_cfg, latent, rehearse, failed, counts, out,
                      first=None, int8=True, quantised=0):
    """One ``'scan'`` request on the serving pipeline against ``first`` (its
    ``'stepwise'`` clip, run here when not given): equal bit for bit, a hit
    of the graph cache with no capture (``hit``) or a miss with one capture
    (its steps are all CFG), the kept pools within ``MAX_KEPT_GRAPH_BYTES``,
    launches as the config derives them (``quantised`` more grouped quantiser
    launches; added to ``counts``).  Returns the stepwise clip."""
    if first is None:
        first, _ = run(serving, "stepwise", kw, output)
    got, scan = run(serving, "scan", kw, output)
    n = len(scan["timings"]["step_ms"])
    cache, captures = scan["dispatch"].get("graph_cache", {}), scan["dispatch"].get("capture_ms", [])
    expected = expected_counts()
    if not rehearse:
        expected = request_launches(model_cfg, latent, n, decode_calls=0 if output == "latent" else 1, int8=int8)
        expected["quantize_weights"] += quantised
    equal = bool(np.array_equal(got, first))
    out[name] = {"graph_cache": cache, "capture_ms": captures, "equal": equal, "denoise_steps": n,
                 "scan_step_ms": scan["timings"]["step_ms"], "scan_s": scan["seconds"],
                 "launches": scan["launches"], "expected_launches": expected}
    if not equal:
        failed.append(f"kept graphs, {name}: scan differs from stepwise")
    if cache.get("hit") is not hit or (hit and captures) or (not hit and len(captures) != (0 if rehearse else 1)):
        failed.append(f"kept graphs, {name}: {cache}, captures {captures}, want hit={hit}")
    if cache.get("pool_bytes", 0) > serving.MAX_KEPT_GRAPH_BYTES:
        failed.append(f"kept graphs, {name}: pools {cache.get('pool_bytes')} bytes over "
                      f"{serving.MAX_KEPT_GRAPH_BYTES}")
    if scan["launches"] != expected:
        failed.append(f"kept graphs, {name}: launches {scan['launches']} != {expected}")
    for k in counts:
        counts[k] += scan["launches"][k]
    return first


def _invalidation_checks(serving, check, failed, out) -> None:
    """After each invalidation point -- FreeU on, FreeU off, int8 switched
    on, an int8 weight written in place (quantised again at the next call),
    the trainer's validation swap -- the next ``'scan'`` request captures
    afresh and equals ``'stepwise'`` (``check``: ``_kept_graph_check``)."""
    import types

    from PIL import Image

    from i2v_adapter_tpu_torch.models.layers import int8_sites
    from i2v_adapter_tpu_torch.training.driver import _run_validation

    kw = dict(seed=5, num_inference_steps=5)
    serving.enable_freeu()
    check("freeu_on", kw, hit=False)
    serving.disable_freeu()
    first = check("freeu_off", kw, hit=False)
    serving.enable_int8_conv(True)
    check("int8_on", kw, hit=False, first=first)
    with torch.no_grad():  # a write nobody announces: its site is quantised again at the next call
        int8_sites(serving.unet)[0].weight.mul_(1.0)
    check("requantised", kw, hit=False, first=first, quantised=1)
    # the trainer's validation: two UNet weights swapped in (.data) and back
    # around a 256 px clip (int8 on for it, off after, as in the driver)
    work = os.path.join(WORK_DIR, "validation")
    os.makedirs(work, exist_ok=True)
    size = serving.pipe_config.height
    Image.fromarray(np.random.default_rng(8).integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
        os.path.join(work, "cond.png"))
    with open(os.path.join(work, "eval.csv"), "w") as f:
        f.write(f"prompt,image_path\na cat,{os.path.join(work, 'cond.png')}\n")
    named = dict(serving.unet.named_parameters())
    trainable = ["conv_out.weight", "conv_out.bias"]
    trained = {n: named[n].detach().float() * 1.01 for n in trainable}
    state = types.SimpleNamespace(ema=None, unet=serving.unet, trainable=trainable,
                                  trainable_params=lambda: trained)
    args = types.SimpleNamespace(eval_csv_path=os.path.join(work, "eval.csv"),
                                 n_frames=serving.pipe_config.num_frames, resolution=size // 2)
    t0 = time.perf_counter()
    clips = _run_validation(args, serving, state, serving.config, work, 0)
    out["validation"] = {"seconds": time.perf_counter() - t0, "shape": list(clips[0].shape),
                         "entries_after": len(serving._graph_cache())}
    shutil.rmtree(work, ignore_errors=True)
    if out["validation"]["entries_after"]:
        failed.append(f"kept graphs: {out['validation']['entries_after']} entries outlived the validation swap")
    check("after_validation", kw, hit=False, int8=False)
    serving.enable_int8_conv(True)  # back to the serving default


def phase_scan(model_cfg, pipe, fused_unet, dev, rehearse: bool):
    """``dispatch='scan'`` against ``'stepwise'`` from the same seed at the
    shapes of the daemon's requests (b), (d), (e) and (f), at the serving
    default on the ``pipeline`` phase's weights, and one
    ``conv_impl='pallas'`` request (exact convs, K4 at every resnet stage):
    the outputs equal bit for bit, each way's launches equal to the config's
    derivation (a CUDA graph's launches counted at every replay), every kind
    used twice or more replayed from a captured graph, step ms by kind each
    way, the captures' host ms, the graphs' pool bytes and each call's peak
    memory.  Then a synthetic full-width LoRA in the peft layout (every
    spatial attention's projections) and in the kohya layout (every
    resnet's 3x3 convs, so the int8 sites) merged into the serving pipeline
    with ``load_lora_weights``: each merge quantises the int8 weights again
    in one grouped launch, and a 5-step ``'scan'`` request captures its
    graphs afresh and gives another clip than before the merges."""
    from i2v_adapter_tpu_torch.config import PipelineConfig
    from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
    from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import cfg_steps, step_kinds
    from i2v_adapter_tpu_torch.pipelines.tiling import temporal_windows
    from i2v_adapter_tpu_torch.utils.safetensors_io import save_file

    size, frames, _ = serving_sizes(rehearse)
    long_frames = 12 if rehearse else 48
    latent = size // model_cfg.vae.spatial_scale_factor
    dtype = "float32" if rehearse else "bfloat16"
    modules = {"unet": pipe.unet, "vae": pipe.vae, "text_encoder": pipe.text_encoder,
               "image_encoder": pipe.image_encoder}
    reset_launch_counts()
    serving = I2VAdapterPipeline(model_cfg, modules, pipe.tokenizer,
                                 PipelineConfig(num_frames=frames, height=size, width=size, blur_sigma=1.0,
                                                dtype=dtype), device=dev)
    load = launch_counts()
    fused_cfg = model_cfg.replace(unet=fused_unet.config)

    def fused():  # exact convs: built last, it switches the shared decoder to exact
        return I2VAdapterPipeline(fused_cfg, dict(modules, unet=fused_unet), pipe.tokenizer,
                                  PipelineConfig(num_frames=frames, height=size, width=size, blur_sigma=1.0,
                                                 dtype=dtype, int8_conv=False), device=dev)

    image = np.random.default_rng(6).integers(0, 256, (size, size, 3), dtype=np.uint8)
    cap = model_cfg.unet.motion_max_seq_length
    window = min(16, cap - 1)
    windows = len(temporal_windows(long_frames, window, max(1, min(12, window - 1))))
    flash, temporal = launches_per_unet_eval(model_cfg.unet, latent, True)
    steps = 7 if rehearse else 25  # (d) and (e): the daemon's 25 steps on the card
    # (pipeline, call arguments, launch derivation of n denoise steps, output)
    serve = lambda: serving  # noqa: E731
    requests = {
        "b_five_steps": (serve, dict(seed=1, num_inference_steps=5),
                         lambda n: request_launches(model_cfg, latent, n), "np"),
        "d_encoder_cache": (serve, dict(seed=2, encoder_cache=2, num_inference_steps=steps),
                            lambda n: request_launches(model_cfg, latent, n, encoder_cache=2, decode_calls=0),
                            "latent"),
        "e_cfg_cutoff": (serve, dict(seed=2, cfg_cutoff=0.5, num_inference_steps=steps),
                         lambda n: request_launches(model_cfg, latent, n, decode_calls=0), "latent"),
        "f_tiled_48": (serve, dict(seed=3, num_inference_steps=3 if rehearse else 5, num_frames=long_frames),
                       lambda n: request_launches(model_cfg, latent, n, windows=windows, decode_calls=0), "latent"),
        "pallas_five_steps": (fused, dict(seed=1, num_inference_steps=5),
                              lambda n: expected_counts(flash_attention=n * flash, temporal_attention_cs=n * temporal,
                                                        conv3x3_kernel=n * conv_launches_per_unet_eval(fused_cfg.unet),
                                                        group_norm_fused=group_norms_per_request(fused_cfg, n,
                                                                                                 decode_calls=0)),
                              "latent"),
    }

    def run(p, dispatch, kw, output):
        reset_launch_counts()
        base = 0
        if not rehearse:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = p("a cat", condition_image=image, output_type=output, dispatch=dispatch, **kw)
        rec = {"seconds": time.perf_counter() - t0, "timings": dict(p.last_timings),
               "dispatch": dict(p.last_dispatch), "launches": launch_counts(),
               "peak_bytes": None if rehearse else torch.cuda.max_memory_allocated() - base}
        return out, rec

    failed, lines, counts, kept = [], {}, expected_counts(), {}

    def check(name, kw, hit, output="latent", first=None, int8=True, quantised=0):
        return _kept_graph_check(name, serving, kw, output, hit, run, model_cfg, latent, rehearse, failed, counts,
                                 kept, first=first, int8=int8, quantised=quantised)

    for rid, (make, kw, derive, output) in requests.items():
        p = make()
        want, step = run(p, "stepwise", kw, output)
        got, scan = run(p, "scan", kw, output)
        n = len(step["timings"]["step_ms"])
        n_cfg = cfg_steps(kw.get("cfg_cutoff", 1.0), n)
        kinds = step_kinds(n, kw.get("encoder_cache", 1), n_cfg)
        expected = expected_counts() if rehearse else derive(n)
        captures = 0 if rehearse else sum(kinds.count(k) > 1 for k in set(kinds))
        equal = bool(np.array_equal(got, want))
        line = {"output": output, "shape": list(got.shape), "denoise_steps": n, "kinds": kinds,
                "equal_to_stepwise": equal, "max_abs_diff": float(np.max(np.abs(got.astype(np.float64)
                                                                                 - want.astype(np.float64)))),
                "stepwise_ms_by_kind": _scan_step_ms(step["timings"]["step_ms"], kinds, False),
                "scan_ms_by_kind": _scan_step_ms(scan["timings"]["step_ms"], kinds, True),
                "stepwise_s": step["seconds"], "scan_s": scan["seconds"],
                "capture_ms": scan["dispatch"].get("capture_ms"),
                "graph_pool_bytes": scan["dispatch"].get("graph_pool_bytes"),
                "graph_cache": scan["dispatch"].get("graph_cache"),
                "peak_bytes_stepwise": step["peak_bytes"], "peak_bytes_scan": scan["peak_bytes"],
                "launches_stepwise": step["launches"], "launches_scan": scan["launches"],
                "expected_launches": expected, "decode_ms": scan["timings"].get("decode_ms")}
        lines[rid] = line
        for k in counts:
            counts[k] += scan["launches"][k]
        if not equal:
            failed.append(f"{rid}: scan differs from stepwise by {line['max_abs_diff']}")
        if step["launches"] != expected or scan["launches"] != expected:
            failed.append(f"{rid}: launches stepwise {step['launches']} / scan {scan['launches']} != {expected}")
        if scan["dispatch"].get("dispatch") != "scan" or len(scan["dispatch"].get("capture_ms", [])) != captures:
            failed.append(f"{rid}: {scan['dispatch']}, not {captures} captured kinds")
        if len(scan["timings"]["step_ms"]) != n:
            failed.append(f"{rid}: {len(scan['timings']['step_ms'])} scan steps, not {n}")
        if rid == "b_five_steps":  # the kept entry replayed: (b) again, then (a)'s 25 steps at its shape
            check("b_repeated", kw, hit=True, output=output, first=want)
            check("a_after_b", dict(seed=0), hit=True)
    del p
    reset_launch_counts()
    serving.enable_int8_conv(True)  # the shared decoder back to int8: one more grouped quantiser launch
    load = {k: load[k] + v for k, v in launch_counts().items()}
    _invalidation_checks(serving, check, failed, kept)
    kept["budget_bytes"] = serving.MAX_KEPT_GRAPH_BYTES

    # LoRA: merge the peft file, then the kohya one, each followed by its
    # int8 weights' one grouped launch; then a 5-step scan request
    lora_dir = os.path.join(WORK_DIR, "lora")
    os.makedirs(lora_dir, exist_ok=True)
    kw = dict(seed=4, num_inference_steps=5)
    before, _ = run(serving, "scan", kw, "latent")
    merges = {}
    for i, layout in enumerate(("peft", "kohya")):
        path = os.path.join(lora_dir, f"{layout}.safetensors")
        save_file(_synthetic_lora(serving.unet, layout, 50 + i), path)
        reset_launch_counts()
        t0 = time.perf_counter()
        patched = serving.load_lora_weights(path, scale=1.0)
        if not rehearse:
            torch.cuda.synchronize()
        merges[layout] = {"patched": patched, "seconds": time.perf_counter() - t0, "launches": launch_counts(),
                          "bytes": os.path.getsize(path)}
    after, rec = run(serving, "scan", kw, "latent")
    after_stepwise, _ = run(serving, "stepwise", kw, "latent")
    shutil.rmtree(lora_dir, ignore_errors=True)
    n = len(rec["timings"]["step_ms"])
    resnets = len([m for m in serving.unet.modules() if type(m).__name__ == "ResnetBlock2D"])
    # the peft file patches attention projections only (no int8 site): no
    # quantiser launch; the kohya file patches every resnet conv: one
    want_merge = {"peft": expected_counts(), "kohya": expected_counts()} if rehearse else {
        "peft": expected_counts(), "kohya": expected_counts(**int8_launches(model_cfg, latent)["per_load"])}
    want_after = expected_counts() if rehearse else request_launches(model_cfg, latent, n, decode_calls=0)
    lora = {"merges": merges, "expected_merge_launches": want_merge, "resnets": resnets,
            "max_abs_change": float(np.max(np.abs(after - before))), "finite": bool(np.isfinite(after).all()),
            "launches": rec["launches"], "expected_launches": want_after,
            "capture_ms": rec["dispatch"].get("capture_ms"), "dispatch": rec["dispatch"].get("dispatch"),
            "graph_cache": rec["dispatch"].get("graph_cache"),
            "equal_to_stepwise": bool(np.array_equal(after, after_stepwise))}
    for k in counts:
        counts[k] += sum(m["launches"][k] for m in merges.values()) + rec["launches"][k] + load[k]
    if merges["kohya"]["patched"] != 2 * resnets:
        failed.append(f"lora: kohya patched {merges['kohya']['patched']} convs of {2 * resnets}")
    if any(m["launches"] != want_merge[layout] for layout, m in merges.items()):
        failed.append(f"lora: merge launches {[m['launches'] for m in merges.values()]} != {want_merge}")
    if not (lora["finite"] and lora["max_abs_change"] > 0) or rec["launches"] != want_after:
        failed.append(f"lora: clip changed {lora['max_abs_change']}, finite {lora['finite']}, "
                      f"launches {rec['launches']} != {want_after}")
    # the merges dropped the kept graphs: the request captured afresh
    if lora["graph_cache"].get("hit") or not lora["equal_to_stepwise"] \
            or len(lora["capture_ms"]) != (0 if rehearse else 1):
        failed.append(f"lora: after the merges {lora['graph_cache']}, captures {lora['capture_ms']}, "
                      f"equal to stepwise {lora['equal_to_stepwise']}")
    emit({"phase": "scan", "requests": lines, "kept_graphs": kept, "lora": lora, "load_launches": load,
          "launches": counts, "failed": failed})
    if failed:
        raise AssertionError(f"scan: {failed}")
    return counts


# the checkpoint directory, the adapter task and the queue live here
# (git-ignored), removed at the end of the run
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_work")
TASK = "smoke_task"


def host_memory_gb() -> dict:
    """The process's peak resident set so far and its current one, GB."""
    with open("/proc/self/statm") as f:
        resident = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return {"peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
            "rss_gb": resident / 1e9}


def port_synth():
    """``tests/torch_port_synth.py`` (the checkpoint writer), loaded by path:
    an installed package named ``tests`` may shadow the repository's."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_port_synth.py")
    spec = importlib.util.spec_from_file_location("torch_port_synth", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def serving_sizes(rehearse: bool):
    """(size, frames, command-line size flags) of the entry-point phases."""
    if rehearse:
        return 32, 2, ["--height", "32", "--width", "32", "--num_frames", "2", "--device", "cpu"]
    return 512, 16, []


def phase_pretrained(model_cfg, dev, rehearse: bool) -> dict:
    """Write the full-width checkpoint directory (fp16) and the adapter task,
    load them with ``from_pretrained`` at the serving default, and check
    that the adapter file's weights are the UNet's (nonzero, each in the
    compute dtype) and the IP head is the standard one."""
    from i2v_adapter_tpu_torch.config import PipelineConfig
    from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
    from i2v_adapter_tpu_torch.utils.convert import extract_i2v_adapter, load_state_dict, to_flax_tree

    synth = port_synth()
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    root, ckpt = os.path.join(WORK_DIR, "sd15"), os.path.join(WORK_DIR, "checkpoint")
    mem_before = host_memory_gb()
    written = synth.write_pretrained_dir(root, model_cfg, seed=11, dtype=np.float16, device=dev)
    adapter = synth.write_adapter_task(ckpt, TASK, model_cfg, epoch=1, seed=12, dtype=np.float16, device=dev)
    mem_written = host_memory_gb()
    if not rehearse:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = I2VAdapterPipeline.from_pretrained(root, model_config=model_cfg, pipeline_config=PipelineConfig(),
                                              i2v_adapter_path=adapter, device=dev)
    if not rehearse:
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    mem_loaded = host_memory_gb()
    adapter_params = {n: p.detach() for n, p in pipe.unet.named_parameters() if ".i2v_adapter." in n}
    got = extract_i2v_adapter(to_flax_tree(pipe.unet, adapter_params))
    want = load_state_dict(adapter)
    mismatched = sorted(k for k in want if got.get(k) is None or not np.array_equal(
        got[k], torch.from_numpy(want[k]).to(pipe.dtype).float().numpy()))
    params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
              for name in ("unet", "vae", "text_encoder", "image_encoder")}
    line = {
        "phase": "pretrained", "config": "I2VModelConfig()" if not rehearse else "tiny_test_config()",
        "dtype_on_disk": "float16", "bytes": written["bytes"], "write_s": written["seconds"],
        "load_s": load_s, "parameters": params, "parameters_total": sum(params.values()),
        "host_memory_before_gb": mem_before, "host_memory_after_write_gb": mem_written,
        "host_memory_after_load_gb": mem_loaded,
        "gpu_peak_memory_gb": None if rehearse else torch.cuda.max_memory_allocated() / 1e9,
        "pipeline_dtype": str(pipe.dtype), "int8_conv": pipe.config.unet.int8_conv,
        "ip_variant": pipe.config.unet.ip_variant, "tokenizer_context": pipe.tokenizer.context_length,
        "adapter_leaves": len(want), "adapter_leaves_mismatched": mismatched,
        "adapter_abs_sum": float(sum(p.float().abs().sum() for p in adapter_params.values())),
    }
    emit(line)
    del pipe, adapter_params, got, want
    if mismatched or not line["adapter_abs_sum"] > 0 or line["ip_variant"] != "standard" \
            or line["tokenizer_context"] != model_cfg.text_encoder.max_position_embeddings:
        raise AssertionError(f"pretrained: adapter mismatched {mismatched[:4]}, ip {line['ip_variant']}, "
                             f"tokenizer {line['tokenizer_context']}")
    return {"root": root, "checkpoint_dir": ckpt, "adapter": adapter}


def _condition_image(size: int) -> str:
    from PIL import Image

    path = os.path.join(WORK_DIR, "cond.png")
    Image.fromarray(np.random.default_rng(6).integers(0, 256, (size, size, 3), dtype=np.uint8)).save(path)
    return path


def _serve_queue(requests: dict, tag: str, run):
    """Queue ``requests`` (in order) under ``WORK_DIR/<tag>/``, then
    ``run(req_dir, out_dir)`` the daemon over them with each request's
    launches read around ``process_request``.  Returns (served, per-request
    launches and timings, result JSONs, request files, out_dir)."""
    from i2v_adapter_tpu_torch.pipelines import serve as serve_mod

    req_dir, out_dir = os.path.join(WORK_DIR, tag, "requests"), os.path.join(WORK_DIR, tag, "output")
    os.makedirs(req_dir)
    for i, (rid, req) in enumerate(requests.items()):
        path = os.path.join(req_dir, rid + ".json")
        with open(path, "w") as f:
            json.dump(req, f)
        os.utime(path, (time.time() + i, time.time() + i))  # the queue's order
    per_request = {}
    real = serve_mod.process_request

    def counted(pipe, req, out_prefix):
        before, pipe.last_timings, pipe.last_dispatch = launch_counts(), {}, {}
        try:
            return real(pipe, req, out_prefix)
        finally:
            after = launch_counts()
            per_request[os.path.basename(out_prefix)] = {
                "launches": {k: after[k] - before[k] for k in after}, "timings": dict(pipe.last_timings),
                "dispatch": dict(pipe.last_dispatch)}

    serve_mod.process_request = counted
    try:
        served = run(req_dir, out_dir)
    finally:
        serve_mod.process_request = real
    results = {}
    for rid in requests:
        with open(os.path.join(out_dir, rid + ".result.json")) as f:
            results[rid] = json.load(f)
    return served, per_request, results, sorted(os.listdir(req_dir)), out_dir


def _check_requests(model_cfg, latent, rehearse, per_request, results, specs, failed) -> dict:
    """Each request against its spec ``(steps, request_launches kwargs,
    output shape or the error's start)``: its denoise steps, its launches as
    the config derives them, its result; returns a summary per request
    (latency, prep / step / decode ms)."""
    out = {}
    for rid, (steps, kw, want) in specs.items():
        rec, res = per_request.get(rid, {"launches": {}, "timings": {}}), results[rid]
        step_ms = rec["timings"].get("step_ms", [])
        expected = expected_counts()
        if steps and not rehearse:
            expected = request_launches(model_cfg, latent, steps, **kw)
        rec["expected_launches"] = expected
        if rec["launches"] != expected:
            failed.append(f"{rid}: launches {rec['launches']} != {expected}")
        if len(step_ms) != steps:
            failed.append(f"{rid}: {len(step_ms)} denoise steps, not {steps}")
        if isinstance(want, str):
            if res["ok"] or not res["error"].startswith(want):
                failed.append(f"{rid}: {res}")
        elif not res["ok"] or res["shape"] != want:
            failed.append(f"{rid}: {res}")
        out[rid] = {"ok": res["ok"], "latency_s": res.get("latency_s"), "prep_ms": rec["timings"].get("prep_ms"),
                    "step_ms_mean": float(np.mean(step_ms)) if step_ms else None, "steps": len(step_ms),
                    "decode_ms": rec["timings"].get("decode_ms"), "launches_as_derived": rec["launches"] == expected,
                    "dispatch": rec.get("dispatch", {}).get("dispatch"),
                    "capture_ms": rec.get("dispatch", {}).get("capture_ms"),
                    "graph_cache": rec.get("dispatch", {}).get("graph_cache")}
    return out


def _npy_ok(path, shape) -> bool:
    if not os.path.exists(path):
        return False
    clip = np.load(path)
    return clip.dtype == np.uint8 and list(clip.shape) == shape and int(clip.max()) > int(clip.min())


def _split_ms(step_ms, first) -> dict:
    """Mean step ms of ``first`` (indices or a count) and of the rest."""
    idx = set(first) if not isinstance(first, int) else set(range(first))
    a = [t for i, t in enumerate(step_ms) if i in idx]
    b = [t for i, t in enumerate(step_ms) if i not in idx]
    return {"n": [len(a), len(b)], "mean_ms": [float(np.mean(a)) if a else None, float(np.mean(b)) if b else None]}


def phase_serve(model_cfg, dev, rehearse: bool, ckpt: dict):
    """The daemon's ``main`` in-process over its queue: (a) the CLI's
    defaults, (b) 5 steps, (c) a missing image, (d) ``encoder_cache: 2`` and
    (e) ``cfg_cutoff: 0.5`` at 25 steps, (j) a request over the card's
    memory envelope, then (f) a 48-frame clip tiled into 4 windows; each
    request's launches are read around ``process_request`` and held to the
    config's derivation; (b) replays the step graphs (a) left, with no
    capture."""
    from PIL import Image

    from i2v_adapter_tpu_torch.pipelines import serve as serve_mod
    from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import cfg_steps
    from i2v_adapter_tpu_torch.pipelines.tiling import temporal_windows
    from i2v_adapter_tpu_torch.utils.image import export_to_gif

    size, frames, flags = serving_sizes(rehearse)
    long_frames = 12 if rehearse else 48
    image = _condition_image(size)
    npy = {"format": "npy"}
    requests = {
        "a_defaults": {"prompt": "a cat", "image": image, "seed": 0},
        "b_five_steps": {"prompt": "a dog", "image": image, "seed": 1, "num_inference_steps": 5, **npy},
        "c_missing_image": {"prompt": "a cat", "image": os.path.join(WORK_DIR, "missing.png")},
        "d_encoder_cache": {"prompt": "a cat", "image": image, "seed": 2, "encoder_cache": 2, **npy},
        "e_cfg_cutoff": {"prompt": "a cat", "image": image, "seed": 2, "cfg_cutoff": 0.5, **npy},
        "j_over_envelope": {"prompt": "a cat", "image": image, "height": 4096, "width": 4096},
        "f_tiled_48": {"prompt": "a cat", "image": image, "seed": 3, "num_inference_steps": 5,
                       "num_frames": long_frames, **npy},
    }
    argv = ["--pretrained_model_path", ckpt["root"], "--task_name", TASK, "--checkpoint_dir",
            ckpt["checkpoint_dir"], "--max_requests", str(len(requests))] + flags
    if not rehearse:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    served, per_request, results, renamed, out_dir = _serve_queue(
        requests, "serve", lambda req_dir, out_dir: serve_mod.main(
            argv + ["--requests_dir", req_dir, "--output_dir", out_dir], model_config=model_cfg))
    total_s = time.perf_counter() - t0
    counts = launch_counts()
    latent = size // model_cfg.vae.spatial_scale_factor
    steps25, steps5 = clip_denoise_steps(25, 0.9), clip_denoise_steps(5, 0.9)
    cap = model_cfg.unet.motion_max_seq_length
    window = min(16, cap - 1)
    windows = len(temporal_windows(long_frames, window, max(1, min(12, window - 1))))
    shape = [1, frames, size, size, 3]
    specs = {
        "a_defaults": (steps25, {}, shape),
        "b_five_steps": (steps5, {}, shape),
        "c_missing_image": (0, {}, "FileNotFoundError"),
        "d_encoder_cache": (steps25, {"encoder_cache": 2}, shape),
        "e_cfg_cutoff": (steps25, {}, shape),
        "j_over_envelope": (0, {}, "ValueError: request of"),
        "f_tiled_48": (steps5, {"windows": windows}, [1, long_frames, size, size, 3]),
    }
    failed = []
    summary_by_request = _check_requests(model_cfg, latent, rehearse, per_request, results, specs, failed)
    if "memory envelope" not in results["j_over_envelope"].get("error", ""):
        failed.append(f"j_over_envelope: {results['j_over_envelope']}")
    for rid, want_frames in (("b_five_steps", frames), ("d_encoder_cache", frames), ("e_cfg_cutoff", frames),
                             ("f_tiled_48", long_frames)):
        if not _npy_ok(os.path.join(out_dir, rid + ".npy"), [1, want_frames, size, size, 3]):
            failed.append(f"{rid}.npy: not a {want_frames}-frame uint8 clip with content")
    clip = np.load(os.path.join(out_dir, "b_five_steps.npy"))
    t0 = time.perf_counter()  # the host's GIF export of one clip, as in request (a)
    export_to_gif(clip[0], os.path.join(out_dir, "b_five_steps_0.gif"))
    gif_export_s = time.perf_counter() - t0
    gif = results["a_defaults"].get("outputs", [None])[0]
    gif_frames = None
    if gif and os.path.exists(gif):
        with Image.open(gif) as im:
            gif_frames = [im.n_frames, *im.size]
    if gif_frames != [frames, size, size]:
        failed.append(f"a_defaults gif {gif}: frames, width, height {gif_frames}")
    done = [f"{rid}.json.{'failed' if isinstance(spec[2], str) else 'done'}" for rid, spec in specs.items()]
    if served != len(requests) or renamed != sorted(done):
        failed.append(f"served {served}, request files {renamed}")
    # outside the requests: the daemon's one load, its int8 weights quantised
    # in one grouped launch
    load = expected_counts() if rehearse else expected_counts(**int8_launches(model_cfg, latent)["per_load"])
    if counts != {k: sum(r["launches"][k] for r in per_request.values()) + load[k] for k in counts}:
        failed.append(f"launches outside the requests: {counts}, the load's {load}")
    # (a), the CLI's defaults, takes 'auto' -> 'scan' (22 x 32 x 4096 eval-tokens <= 8 M)
    if not rehearse and per_request.get("a_defaults", {}).get("dispatch", {}).get("dispatch") != "scan":
        failed.append(f"a_defaults: dispatch {per_request.get('a_defaults', {}).get('dispatch')}, not 'scan'")
    # (b) has (a)'s shape: it replays the step graphs (a) left in the cache
    b = per_request.get("b_five_steps", {}).get("dispatch", {})
    if not rehearse and (not b.get("graph_cache", {}).get("hit") or b.get("capture_ms")):
        failed.append(f"b_five_steps: {b}, not a hit of the kept graphs without a capture")
    a = per_request.get("a_defaults", {}).get("timings", {})
    step_ms = a.get("step_ms") or [float("nan")]
    d_ms = per_request.get("d_encoder_cache", {}).get("timings", {}).get("step_ms", [])
    e_ms = per_request.get("e_cfg_cutoff", {}).get("timings", {}).get("step_ms", [])
    emit({
        "phase": "serve", "argv": argv, "served": served, "seconds": total_s,
        "peak_memory_gb": None if rehearse else torch.cuda.max_memory_allocated() / 1e9,
        "results": results, "request_files": renamed,
        "clip_latency_s": results["a_defaults"].get("latency_s"),
        "clip_timings_ms": {"prep": a.get("prep_ms"), "step_mean": float(np.mean(step_ms)),
                            "step_min": float(np.min(step_ms)), "step_max": float(np.max(step_ms)),
                            "steps": len(step_ms), "decode": a.get("decode_ms")},
        "requests": summary_by_request,
        # (d): full steps at even indices of the pairs, cached at odd; (e):
        # the leading CFG steps, then cond-only
        "encoder_cache_full_vs_cached": _split_ms(d_ms, range(0, len(d_ms) - len(d_ms) % 2, 2)) if d_ms else None,
        "cfg_cutoff_cfg_vs_cond": _split_ms(e_ms, cfg_steps(0.5, len(e_ms))) if e_ms else None,
        "tiled_windows": windows,
        "gif_export_s": gif_export_s,
        "per_request": per_request, "gif_frames_width_height": gif_frames,
        "launches_per_unet_eval": {"flash_attention": launches_per_unet_eval(model_cfg.unet, latent, True)[0],
                                   "temporal_attention_cs": launches_per_unet_eval(model_cfg.unet, latent, True)[1],
                                   **int8_launches(model_cfg, latent)["per_eval"]},
        "launches_per_cached_eval": int8_launches(model_cfg, latent, cached=True)["per_eval"],
        "launches_per_decode": int8_launches(model_cfg, latent)["per_decode"],
        "launches_per_load": int8_launches(model_cfg, latent)["per_load"], "launches": counts,
        "failed": failed,
    })
    if failed:
        raise AssertionError(f"serve: {failed}")
    return counts


# the card's memory budgets: the share of its memory the pipeline plans to
# use (the rest: the CUDA context, the allocator's fragmentation, cuDNN and
# cuBLAS workspaces), and the share of what the weights leave that goes to
# one UNet evaluation's working set (the rest: encoder_cache=2's features)
MEMORY_USABLE = 0.9
ENVELOPE_SHARE = 0.75
ENVELOPE_EVALS = (32, 64)  # frame-evaluations measured at 512 px
DECODE_FRAMES = (8, 16)  # frames per decoder call measured at 512 px


def _memory_budgets(pipe, model_cfg, dev, rehearse: bool) -> dict:
    """Peak memory of one 512 px UNet evaluation (the serving default) at
    ``ENVELOPE_EVALS`` frame-evaluations, and of one decoder call at
    ``DECODE_FRAMES`` frames, each fitted as weights + a + b * count; the
    budgets this card gives (``MEMORY_USABLE``; ``ENVELOPE_SHARE`` for the
    evaluation beside the encoder cache, all the room for the decode, which
    runs alone), against the pipeline's constants; the encoder cache of one
    full step against ``_encoder_cache_elems_per_eval``; then one
    evaluation and one decoder call at the constants' envelopes, whose peaks
    must stay inside the card's usable share.  Every measurement runs with
    the step graphs of a 512 px 16-frame ``'scan'`` request kept (their
    pool within ``MAX_KEPT_GRAPH_BYTES``): the evaluation at the envelope
    must fit beside the whole pool, the decode beside what the pipeline
    keeps beside it (``_graph_rooms``), and a ``'scan'`` request at the
    envelope drops the kept entry and keeps none of its own."""
    from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import _encoder_cache_elems_per_eval

    if rehearse:
        return {"skipped": "rehearsal: memory is the card's"}
    ucfg, lat = model_cfg.unet, 64
    tokens = lat * lat
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    g = torch.Generator(device=dev).manual_seed(7)
    image = np.random.default_rng(9).integers(0, 256, (512, 512, 3), dtype=np.uint8)
    pipe.release_graphs()
    pipe("a cat", condition_image=image, num_frames=16, height=512, width=512, num_inference_steps=3,
         output_type="latent", dispatch="scan", seed=1)
    kept = dict(pipe.last_dispatch["graph_cache"])
    kept_bytes = kept.get("pool_bytes", 0)

    def peak_of_eval(evals):
        clips = evals // 16
        sample = torch.randn(clips, 16, lat, lat, ucfg.in_channels, generator=g, device=dev).to(pipe.dtype)
        text = torch.randn(clips, 77, ucfg.cross_attention_dim, generator=g, device=dev).to(pipe.dtype)
        img = torch.randn(clips, ucfg.image_embed_dim, generator=g, device=dev).to(pipe.dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.inference_mode():
            out = pipe.unet(sample, torch.full((clips,), 501.0, device=dev), text, img,
                            enable_cross_frame_attn=True)
            finite = bool(torch.isfinite(out).all())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del sample, text, img, out
        torch.cuda.empty_cache()
        return peak, finite

    def peak_of_decode(frames):
        z = torch.randn(frames, lat, lat, 4, generator=g, device=dev).to(pipe.dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.inference_mode():
            finite = bool(torch.isfinite(pipe.vae.decode(z)).all())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del z
        torch.cuda.empty_cache()
        return peak, finite

    def fit(peaks):
        (n0, p0), (n1, p1) = sorted(peaks.items())
        slope = (p1 - p0) / (n1 - n0)
        return slope, p0 - slope * n0

    peaks = {e: peak_of_eval(e)[0] for e in ENVELOPE_EVALS}
    per_eval, fixed = fit(peaks)
    room = total * MEMORY_USABLE - weights - fixed
    evals_max = int(room * ENVELOPE_SHARE // per_eval) // 16 * 16
    cache_budget = int(room * (1 - ENVELOPE_SHARE) // 1e9) * 1_000_000_000
    const_evals = pipe.MAX_EVAL_TOKENS // tokens
    decode_peaks = {n: peak_of_decode(n)[0] for n in DECODE_FRAMES}
    per_frame, decode_fixed = fit(decode_peaks)
    decode_frames_max = int((total * MEMORY_USABLE - weights - decode_fixed) // per_frame)
    # the encoder cache of one full step at the serving shape (16 frames, CFG)
    parts = pipe._build_parts(1, 16, 512, 512, 25, 0.9, 7.5, True, True)
    consts = (torch.zeros(1, lat, lat, 4, device=dev), torch.zeros(2, 77, ucfg.cross_attention_dim, device=dev,
                                                                     dtype=pipe.dtype),
              torch.zeros(2, ucfg.image_embed_dim, device=dev, dtype=pipe.dtype))
    latents = torch.randn(1, 16, lat, lat, 4, generator=g, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with torch.inference_mode():
        latents, caches = parts[5][0](consts, latents, 501, 461)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before - latents.numel() * latents.element_size()
    tensors = [caches[0][0], *caches[0][1]]
    cache_bytes = sum(t.numel() * t.element_size() for t in tensors)
    formula = 32 * _encoder_cache_elems_per_eval(ucfg, lat, lat) * 2
    del caches, latents, tensors, parts, consts
    torch.cuda.empty_cache()
    # one evaluation and one decoder call at the pipeline's envelopes, their
    # peaks held to the card
    at_envelope, finite = peak_of_eval(const_evals // 16 * 16)
    const_frames = pipe.MAX_DECODE_TOKENS // tokens
    decode_at_envelope, decode_finite = peak_of_decode(const_frames)
    # one 'scan' request at the envelope (16-frame CFG clips: 32 frame-
    # evaluations each), 2 denoise steps: the eager step, then the capture
    # and its replay, the graphs' pool in place of the eager working set
    clips = const_evals // 32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    lat_out = pipe(["a cat"] * clips, condition_image=image, num_frames=16, height=512, width=512,
                   num_inference_steps=3, output_type="latent", dispatch="scan", seed=0)
    scan_peak = torch.cuda.max_memory_allocated() - base
    # what the card held: the allocator's reserve, the graphs' pool included
    scan_reserved = torch.cuda.max_memory_reserved()
    scan_request = {"clips": clips, "frame_evals": 32 * clips, "peak_bytes": scan_peak,
                    "peak_with_weights_share": (weights + scan_peak) / total,
                    "peak_reserved_bytes": scan_reserved, "peak_reserved_share": scan_reserved / total,
                    "graph_pool_bytes": pipe.last_dispatch.get("graph_pool_bytes"),
                    "capture_ms": pipe.last_dispatch.get("capture_ms"), "step_ms": pipe.last_timings["step_ms"],
                    "graph_cache": pipe.last_dispatch.get("graph_cache"),
                    "finite": bool(np.isfinite(lat_out).all())}
    del lat_out
    torch.cuda.empty_cache()
    out = {
        "card_total_bytes": total, "weights_bytes": weights,
        "eval_peak_bytes": {str(k): v for k, v in peaks.items()},
        "per_eval_bytes": per_eval, "fixed_bytes": fixed,
        "usable_share": MEMORY_USABLE, "envelope_share": ENVELOPE_SHARE,
        "derived_max_eval_tokens": evals_max * tokens, "derived_max_enc_cache_bytes": cache_budget,
        "max_eval_tokens": pipe.MAX_EVAL_TOKENS, "max_enc_cache_bytes": pipe.MAX_ENC_CACHE_BYTES,
        "encoder_cache_bytes_one_step": cache_bytes, "encoder_cache_formula_bytes": formula,
        "encoder_cache_held_bytes": held,
        "envelope_evals": const_evals, "envelope_eval_peak_bytes": at_envelope,
        "envelope_eval_peak_with_weights_share": (weights + at_envelope) / total, "envelope_eval_finite": finite,
        "decode_peak_bytes": {str(k): v for k, v in decode_peaks.items()},
        "decode_per_frame_bytes": per_frame, "decode_fixed_bytes": decode_fixed,
        "derived_max_decode_tokens": decode_frames_max * tokens, "max_decode_tokens": pipe.MAX_DECODE_TOKENS,
        "decode_envelope_frames": const_frames, "decode_envelope_peak_bytes": decode_at_envelope,
        "decode_envelope_peak_with_weights_share": (weights + decode_at_envelope) / total,
        "decode_envelope_finite": decode_finite, "scan_request_at_envelope": scan_request,
        "kept_graphs": kept, "max_kept_graph_bytes": pipe.MAX_KEPT_GRAPH_BYTES,
        "envelope_eval_with_kept_share": (weights + at_envelope + kept_bytes) / total,
        "kept_beside_envelope_decode_bytes": min(kept_bytes, pipe._graph_rooms(0, 0, pipe.MAX_DECODE_TOKENS)[1]),
    }
    failed = []
    if cache_bytes != formula:
        failed.append(f"encoder cache {cache_bytes} bytes, the formula says {formula}")
    if pipe.MAX_EVAL_TOKENS > evals_max * tokens or pipe.MAX_ENC_CACHE_BYTES > cache_budget \
            or pipe.MAX_DECODE_TOKENS > decode_frames_max * tokens:
        failed.append("a budget constant exceeds what this run's measurements allow")
    if weights + at_envelope > total * MEMORY_USABLE or not finite:
        failed.append(f"one evaluation at the envelope peaked at {weights + at_envelope} bytes of {total}")
    beside = out["kept_beside_envelope_decode_bytes"]
    if weights + decode_at_envelope + beside > total * MEMORY_USABLE or not decode_finite:
        failed.append(f"one decode at the envelope peaked at {weights + decode_at_envelope} bytes of {total} "
                      f"beside {beside} kept")
    if not kept.get("kept") or not 0 < kept_bytes <= pipe.MAX_KEPT_GRAPH_BYTES:
        failed.append(f"the 16-frame request's graphs: {kept}, budget {pipe.MAX_KEPT_GRAPH_BYTES}")
    if weights + at_envelope + kept_bytes > total * MEMORY_USABLE:
        failed.append(f"one evaluation at the envelope beside {kept_bytes} kept bytes: "
                      f"{weights + at_envelope + kept_bytes} of {total}")
    if (scan_request["graph_cache"] or {}).get("entries") != 0:
        failed.append(f"the scan request at the envelope left {scan_request['graph_cache']}")
    if max(weights + scan_peak, scan_reserved) > total * MEMORY_USABLE or not scan_request["finite"]:
        failed.append(f"a scan request at the envelope peaked at {weights + scan_peak} bytes allocated, "
                      f"{scan_reserved} reserved, of {total}")
    out["failed"] = failed
    return out


def _tiled_decode(pipe, model_cfg, dev, rehearse: bool) -> dict:
    """``vae_tiling``'s decode (``decode_tiled``, 64-latent tiles) of 16
    frames at 768 px, where it cuts 2 x 2 tiles, against the untiled decode
    of the same latents at the serving default: PSNR, times, the int8 conv's
    launches (one decoder per tile)."""
    from i2v_adapter_tpu_torch.models.vae import decode_tiled

    frames, lat, tile = (2, 12, 8) if rehearse else (16, 96, 64)
    g = torch.Generator(device=dev).manual_seed(8)
    z = torch.randn(frames, lat, lat, model_cfg.vae.latent_channels, generator=g, device=dev).to(pipe.dtype)
    sync = (lambda: None) if rehearse else torch.cuda.synchronize
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        whole = pipe.vae.decode(z).float()
        sync()
        t1 = time.perf_counter()
        reset_launch_counts()
        tiled = decode_tiled(pipe.vae.decode, z, tile_latent_size=tile).float()
        sync()
        t2 = time.perf_counter()
        counts = launch_counts()
    n_tiles = len(range(0, max(lat - tile // 4, 1), tile * 3 // 4)) ** 2
    per_decode = dict(int8_launches(model_cfg, lat)["per_decode"],
                      group_norm_fused=group_norms_per_vae_call(model_cfg.vae, "decoder"))
    expected = expected_counts() if rehearse else expected_counts(
        **{k: n_tiles * v for k, v in per_decode.items()})
    finite = bool(torch.isfinite(tiled).all())
    line = {"frames": frames, "latent": lat, "tile_latent_size": tile, "tiles": n_tiles,
            "shape": list(tiled.shape), "psnr_db_vs_untiled": psnr(tiled.cpu().numpy(), whole.cpu().numpy()),
            "untiled_ms": (t1 - t0) * 1e3, "tiled_ms": (t2 - t1) * 1e3, "finite": finite,
            "launches": counts, "expected_launches": expected}
    line["failed"] = [] if (finite and counts == expected and tiled.shape == whole.shape) else [
        f"tiled decode: finite {finite}, launches {counts} != {expected}"]
    return line


def phase_serve_heads(model_cfg, dev, rehearse: bool, ckpt: dict):
    """The same directory with the standard head at the serving default: the
    card's memory budgets, the tiled decode, then (g) a FreeU request
    (``enable_freeu``); then the directory with (h) a plus and (i) a
    full_face IP-Adapter file written beside it (seeded, the published
    heads' geometry: 16 x 768 latents, 4 perceiver layers; 1280 -> 1280 ->
    768), each loaded by ``from_pretrained`` and served one 5-step request
    by the daemon's loop.  Launches per request held to the derivation
    (full_face: the IP attention's 257 keys through K1 at every site)."""
    from i2v_adapter_tpu_torch.config import PipelineConfig
    from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
    from i2v_adapter_tpu_torch.pipelines import serve as serve_mod

    synth = port_synth()
    size, frames, _ = serving_sizes(rehearse)
    latent = size // model_cfg.vae.spatial_scale_factor
    image = _condition_image(size)
    pcfg = PipelineConfig(num_frames=frames, height=size, width=size,
                          dtype="float32" if rehearse else "bfloat16")
    head_kw = dict(num_tokens=6, resampler_dim=12, depth=2) if rehearse else {}
    ip_files = {}
    for i, variant in enumerate(("plus", "full_face")):
        ip_files[variant] = os.path.join(WORK_DIR, f"ip-adapter-{variant}.bin")
        synth.save_ip_adapter(synth.make_ip_adapter_sd(synth.Draw(40 + i, np.float16, dev), model_cfg, variant,
                                                       **head_kw), ip_files[variant])
    steps5 = clip_denoise_steps(5, 0.9)
    shape = [1, frames, size, size, 3]
    req = {"prompt": "a cat", "image": image, "seed": 4, "num_inference_steps": 5, "format": "npy"}
    failed, lines = [], {}
    reset_launch_counts()
    for head in ("standard", "plus", "full_face"):
        t0 = time.perf_counter()
        pipe = I2VAdapterPipeline.from_pretrained(
            ckpt["root"], model_config=model_cfg, pipeline_config=pcfg, i2v_adapter_path=ckpt["adapter"],
            ip_adapter_path=ip_files.get(head), device=dev)
        load_s = time.perf_counter() - t0
        line = {"load_s": load_s, "ip_variant": pipe.config.unet.ip_variant,
                "ip_tokens": pipe.config.unet.ip_num_tokens}
        if pipe.config.unet.ip_variant != head:
            failed.append(f"{head}: loaded as {pipe.config.unet.ip_variant}")
        if head == "standard":
            line["memory"] = _memory_budgets(pipe, model_cfg, dev, rehearse)
            line["tiled_decode"] = _tiled_decode(pipe, model_cfg, dev, rehearse)
            failed += line["memory"].get("failed", []) + line["tiled_decode"]["failed"]
            reset_launch_counts()  # the launches above are the checks', not a request's
            pipe.enable_freeu()
            rid = "g_freeu"
        else:
            rid = "h_plus" if head == "plus" else "i_full_face"
        ip_tokens = pipe.config.unet.ip_num_tokens if head == "full_face" else 0
        served, per_request, results, _, out_dir = _serve_queue(
            {rid: req}, rid, lambda req_dir, out_dir: serve_mod.serve(pipe, req_dir, out_dir, max_requests=1))
        line["requests"] = _check_requests(model_cfg, latent, rehearse, per_request, results,
                                           {rid: (steps5, {"ip_tokens": ip_tokens}, shape)}, failed)
        line["per_request"] = per_request
        if served != 1:
            failed.append(f"{rid}: served {served}")
        if not _npy_ok(os.path.join(out_dir, rid + ".npy"), shape):
            failed.append(f"{rid}.npy: not a {frames}-frame uint8 clip with content")
        if head == "standard":
            line["freeu"] = pipe.config.unet.freeu
            pipe.disable_freeu()
        lines[head] = line
        del pipe
        if not rehearse:
            torch.cuda.empty_cache()
    counts = launch_counts()
    emit({"phase": "serve_heads", "ip_files": {k: os.path.getsize(v) for k, v in ip_files.items()},
          "heads": lines, "launches": counts, "failed": failed})
    if failed:
        raise AssertionError(f"serve_heads: {failed}")
    return counts


def phase_cli(model_cfg, dev, rehearse: bool, ckpt: dict):
    """The CLI on a one-row CSV with the adapter task, exact convs, 5 steps:
    one GIF; K1 and K2 launched as derived for its denoise steps."""
    from PIL import Image

    from i2v_adapter_tpu_torch.pipelines import cli

    size, frames, flags = serving_sizes(rehearse)
    eval_csv, out_dir = os.path.join(WORK_DIR, "eval.csv"), os.path.join(WORK_DIR, "samples")
    with open(eval_csv, "w") as f:
        f.write(f"prompt,image_path\na cat,{_condition_image(size)}\n")
    argv = ["--task_name", TASK, "--checkpoint_dir", ckpt["checkpoint_dir"], "--pretrained_model_path",
            ckpt["root"], "--eval_csv_path", eval_csv, "--output_dir", out_dir, "--no-int8_conv",
            "--num_inference_steps", "5"] + flags
    reset_launch_counts()
    t0 = time.perf_counter()
    written = cli.main(argv, model_config=model_cfg)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    latent = size // model_cfg.vae.spatial_scale_factor
    flash, temporal = launches_per_unet_eval(model_cfg.unet, latent, True)
    steps = clip_denoise_steps(5, 0.9)
    expected = expected_counts() if rehearse else expected_counts(
        flash_attention=steps * flash, temporal_attention_cs=steps * temporal,
        group_norm_fused=group_norms_per_request(model_cfg, steps))
    gif_frames = None
    if len(written) == 1 and os.path.exists(written[0]):
        with Image.open(written[0]) as im:
            gif_frames = [im.n_frames, *im.size]
    emit({"phase": "cli", "argv": argv, "seconds": seconds, "outputs": written,
          "gif_frames_width_height": gif_frames, "launches": counts, "expected_launches": expected})
    if gif_frames != [frames, size, size] or counts != expected:
        raise AssertionError(f"cli: outputs {written} {gif_frames}, launches {counts} != {expected}")
    return counts


# the mesh phase: one rank per visible card, spawned as --mesh spawns them
MESH_STEPS = 5
MESH_EVAL_PSNR_MIN = 40.0
MESH_CLIP_PSNR_MIN = 35.0
# the int8 clip's distance from one card is held to the card's own: the same
# card's int8 clip with attention through the plain version (fp32 softmax)
# in place of the kernels, less this margin.  An int8 activation that lands
# on another rounding bucket moves a conv output by a 127th of its range,
# so any perturbation of the int8 clip (the mesh's or the card's own)
# reads about 33 dB at 5 steps, while the exact-conv clips stay over 40 dB
MESH_INT8_CLIP_MARGIN_DB = 1.0
MESH_TIMEOUT_S = 600


def mesh_shapes(cards: int, rehearse: bool) -> list:
    """The (data, tensor, seq) meshes of the mesh phase on ``cards`` cards
    (two gloo ranks in the rehearsal)."""
    if rehearse:
        return [(2, 1, 1), (1, 1, 2)]
    if cards >= 4:
        return [(2, 1, 2), (1, 1, 4), (2, 2, 1)]
    return [(1, 1, 1)]


def mesh_launches_per_eval(model_cfg, latent: int, mesh: tuple, frames: int) -> dict:
    """One rank's kernel launches for one meshed UNet evaluation (CFG, one
    clip): K1 as on one card (each site runs once on the rank's slab), K2 at
    the motion modules whose local token count (S / seq when the frames and
    the tokens split, else S) reaches 128, the int8 sites as on one card,
    the GroupNorm kernel at every site but the motion modules' when ``seq``
    splits the frames (``parallel.spmd.motion_group_norm`` sums over the
    ranks)."""
    ucfg = model_cfg.unet
    flash, _ = launches_per_unet_eval(ucfg, latent, True)
    s = mesh[2]
    split = s > 1 and frames % s == 0
    n = ucfg.num_blocks
    levels = [(latent >> i, ucfg.layers_per_block, ucfg.use_motion_modules) for i in range(n)]
    levels.append((latent >> (n - 1), 1, ucfg.use_motion_modules and ucfg.use_motion_mid_block))
    levels += [(latent >> (n - 1 - i), ucfg.layers_per_block + 1, ucfg.use_motion_modules) for i in range(n)]
    temporal = 0
    for h, layers, motion in levels:
        tokens = h * h
        local = tokens // s if split and tokens % s == 0 else tokens
        temporal += 2 * layers if motion and local >= 128 else 0
    int8 = int8_launches(model_cfg, latent)["per_eval"]
    sites = [site for site in unet_group_norm_sites(ucfg) if s == 1 or site[1] != "motion"]
    return expected_counts(flash_attention=flash, temporal_attention_cs=temporal,
                           int8_conv3x3_kernel=int8["int8_conv3x3_kernel"], int8_matmul=int8["int8_matmul"],
                           group_norm_fused=_unet_group_norms(ucfg.replace(int8_conv=True), sites, torch.bfloat16))


def _mesh_rank(meshes, model_cfg, size: int, frames: int, rehearse: bool) -> dict:
    """One rank of the mesh phase: the serving default with seeded random
    weights (the same on every rank); one UNet evaluation and a
    ``MESH_STEPS``-step clip on this card alone, then per mesh the same
    evaluation and clip (twice: the first captures the step graphs, the
    second replays them) with this rank's launches, one step's collectives
    (``tools.audit_multichip.audit_step``) and peak memory."""
    from i2v_adapter_tpu_torch.config import MeshConfig, PipelineConfig
    from i2v_adapter_tpu_torch.ops import launches
    from i2v_adapter_tpu_torch.parallel import collectives
    from i2v_adapter_tpu_torch.parallel.mesh import create_mesh
    from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import meshed_unet_eval
    from i2v_adapter_tpu_torch.tools.audit_multichip import audit_step
    from i2v_adapter_tpu_torch.utils.random_init import random_pipeline

    dev = torch.device("cpu") if rehearse else torch.device("cuda", torch.cuda.current_device())
    cuda = dev.type == "cuda"
    pc = PipelineConfig(num_frames=frames, height=size, width=size, num_inference_steps=MESH_STEPS,
                        **({"dtype": "float32"} if rehearse else {}))
    pipe = random_pipeline(model_cfg, pc, dev, seed=1)
    image = np.random.default_rng(6).integers(0, 256, (size, size, 3), dtype=np.uint8)
    parts = pipe._build_parts(1, frames, size, size, MESH_STEPS, 0.9, 7.5, True, True)
    isz = model_cfg.image_encoder.image_size
    cond = np.random.default_rng(7).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    clip_img = np.random.default_rng(8).standard_normal((1, isz, isz, 3)).astype(np.float32)
    with torch.inference_mode():
        latents, consts = parts[0](pipe.tokenizer(["", "a cat"]), cond, clip_img,
                                   torch.Generator(device=dev).manual_seed(0))
    x = torch.cat([latents, latents])
    t = torch.full((2,), float(parts[3][0]), device=dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def evaluation(mesh):
        with torch.inference_mode():
            eps = meshed_unet_eval(mesh, lambda xl, c, i: pipe.unet(
                xl.to(pipe.dtype), t[: xl.shape[0]], c, i, enable_cross_frame_attn=True), x, consts[1], consts[2])
            return eps.float().cpu().numpy()

    def clip(output="float"):
        t0 = time.perf_counter()
        out = pipe("a cat", condition_image=image, seed=3, output_type=output, dispatch="scan")
        return out, time.perf_counter() - t0

    def exact(fn):  # fn() with exact convs (the same weights)
        pipe.enable_int8_conv(False)
        try:
            return fn()
        finally:
            pipe.enable_int8_conv(True)

    def timings():
        steps = pipe.last_timings.get("step_ms", [])
        return {"prep_ms": pipe.last_timings.get("prep_ms"), "step_ms_mean": float(np.mean(steps)),
                "steps": len(steps), "decode_ms": pipe.last_timings.get("decode_ms")}

    ref_eval = evaluation(None)
    clip()
    ref_clip, ref_s = clip()
    rec = {"one_card": {"latency_s": ref_s, **timings()}, "meshes": []}
    ref_latents = clip("latent")[0]
    ref_exact_eval, ref_exact_clip = exact(lambda: (evaluation(None), clip()[0]))
    if any(m[0] * m[1] * m[2] > 1 for m in meshes):
        # what a perturbation of one card's own rounding does to the same
        # int8 evaluation and clip: attention through the plain version
        # (fp32 softmax) in place of the kernels
        pipe.unet.set_attn_impl("plain")
        rec["one_card"]["plain_attention_eval_psnr_db"] = psnr(evaluation(None), ref_eval)
        rec["one_card"]["plain_attention_clip_psnr_db"] = psnr(clip()[0], ref_clip)
        pipe.unet.set_attn_impl("auto")
    for sizes in meshes:
        mesh = create_mesh(MeshConfig(data=sizes[0], fsdp=1, tensor=sizes[1], seq=sizes[2]), device=dev)
        pipe.enable_mesh(mesh)
        launches.reset()
        calls = collectives.calls
        got_eval = evaluation(mesh)
        sync()
        eval_launches, eval_calls = launch_counts(), collectives.calls - calls
        step_audit = audit_step(pipe, size, frames)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        launches.reset()
        _, first_s = clip()
        first_launches = launch_counts()
        launches.reset()
        got_clip, latency_s = clip()
        clip_launches = launch_counts()
        timing = timings()
        got_latents = clip("latent")[0]
        exact_eval, exact_clip = exact(lambda: (evaluation(mesh), clip()[0]))
        rec["meshes"].append({
            "mesh": ",".join(map(str, sizes)), "latency_s": latency_s, "first_latency_s": first_s, **timing,
            "eval_psnr_db": psnr(got_eval, ref_eval), "clip_psnr_db": psnr(got_clip, ref_clip),
            "latents_psnr_db": psnr(got_latents, ref_latents), "exact_eval_psnr_db": psnr(exact_eval, ref_exact_eval),
            "exact_clip_psnr_db": psnr(exact_clip, ref_exact_clip),
            "eval_equal": bool(np.array_equal(got_eval, ref_eval)), "clip_equal": bool(np.array_equal(got_clip, ref_clip)),
            "finite": bool(np.isfinite(got_clip).all()),
            "eval_launches": eval_launches, "eval_collectives": eval_calls,
            "clip_launches_capture": first_launches, "clip_launches": clip_launches,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
            "graph_cache": dict(pipe.last_dispatch.get("graph_cache", {})),
            "collectives_per_step": {k: {"count": v["count"], "bytes": v["out_bytes"], "ms": v["ms"],
                                         "wire_bytes_per_device": v["wire_bytes_per_device"],
                                         "bound_ms": v["wire_bytes_per_device"] / PEAK_NVLINK_BYTES * 1e3}
                                     for k, v in step_audit["summary"]["by_kind"].items()},
            "collectives_ms_per_step": step_audit["summary"]["ms"],
            "collectives_expected": step_audit["expected"],
            "decode_collectives": {k: v["count"] for k, v in step_audit["decode"]["by_kind"].items()},
            "decode_collectives_expected": step_audit["decode_expected"],
        })
        pipe.disable_mesh()
    return rec


def _mesh_daemon(ckpt: dict, model_cfg, mesh: str) -> dict:
    """The daemon's request (a) (the CLI's defaults, 22 steps; ``npy``
    output) through ``serve.main --mesh``, which spawns the ranks, then (a)
    again with another seed (the kept step graphs replayed: the warm
    latency)."""
    from i2v_adapter_tpu_torch.pipelines import serve as serve_mod

    req_dir, out_dir = os.path.join(WORK_DIR, "mesh", "requests"), os.path.join(WORK_DIR, "mesh", "output")
    os.makedirs(req_dir)
    image = _condition_image(512)
    for i, rid in enumerate(("a_defaults", "a_repeat")):
        path = os.path.join(req_dir, rid + ".json")
        with open(path, "w") as f:
            json.dump({"prompt": "a cat", "image": image, "seed": i, "format": "npy"}, f)
        os.utime(path, (time.time() + i, time.time() + i))
    t0 = time.perf_counter()
    served = serve_mod.main(["--pretrained_model_path", ckpt["root"], "--task_name", TASK, "--checkpoint_dir",
                             ckpt["checkpoint_dir"], "--max_requests", "2", "--mesh", mesh,
                             "--requests_dir", req_dir, "--output_dir", out_dir], model_config=model_cfg)
    results, shapes = {}, {}
    for rid in ("a_defaults", "a_repeat"):
        with open(os.path.join(out_dir, rid + ".result.json")) as f:
            results[rid] = json.load(f)
        video = np.load(os.path.join(out_dir, rid + ".npy")) if results[rid].get("ok") else None
        shapes[rid] = None if video is None or not np.isfinite(video).all() else list(video.shape)
    return {"mesh": mesh, "served": served, "seconds": time.perf_counter() - t0, "results": results,
            "finite_shapes": shapes}


def phase_mesh(model_cfg, dev, rehearse: bool, ckpt: dict):
    """One clip over several cards: one rank per visible card, spawned by
    ``parallel.launch.run_ranks`` (the ``--mesh`` entry's), at full width,
    512 px, 16 frames, the serving default, ``MESH_STEPS`` steps: per mesh
    (``mesh_shapes``) the UNet evaluation's and the clip's PSNR against the
    same card alone (at (1,1,1) equal bit for bit), latency, step and decode
    ms, each rank's peak memory and launches (against
    ``mesh_launches_per_eval``), one step's collectives (count, bytes, ms;
    against ``parallel.audit``'s formula); on 4 cards the daemon's request
    (a) at (2,1,2).  Any rank failing or hanging fails the phase."""
    from i2v_adapter_tpu_torch.parallel.launch import run_ranks

    cards = 2 if rehearse else torch.cuda.device_count()
    meshes = mesh_shapes(cards, rehearse)
    ranks = max(m[0] * m[1] * m[2] for m in meshes)
    size, frames, _ = serving_sizes(rehearse)
    latent = size // model_cfg.vae.spatial_scale_factor
    if not rehearse:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = run_ranks(_mesh_rank, ranks, (meshes, model_cfg, size, frames, rehearse),
                     device="cpu" if rehearse else None, timeout=MESH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    steps = clip_denoise_steps(MESH_STEPS)
    # each rank's prep (the condition image's encode) and decode call
    decode = expected_counts(**int8_launches(model_cfg, latent)["per_decode"],
                             group_norm_fused=group_norms_per_request(model_cfg, 0))
    failed, lines = [], []
    for i, sizes in enumerate(meshes):
        per = [r["meshes"][i] for r in recs]
        m = dict(per[0])
        per_eval = expected_counts() if rehearse else mesh_launches_per_eval(model_cfg, latent, sizes, frames)
        want_clip = {k: steps * per_eval[k] + (0 if rehearse else decode[k]) for k in per_eval}
        m.update(launches_per_rank=[r["clip_launches"] for r in per],
                 eval_launches_per_rank=[r["eval_launches"] for r in per],
                 peak_gb_per_rank=[r["peak_gb"] for r in per], expected_eval_launches=per_eval,
                 expected_clip_launches=want_clip)
        for key in ("clip_launches", "clip_launches_capture", "eval_launches", "peak_gb"):
            m.pop(key, None)
        name = m["mesh"]
        if any(r["eval_launches"] != per_eval or r["clip_launches"] != want_clip
               or r["clip_launches_capture"] != want_clip for r in per):
            failed.append(f"{name}: launches per rank {[r['clip_launches'] for r in per]} != {want_clip}")
        counts = {k: v["count"] for k, v in m["collectives_per_step"].items()}
        if counts != m["collectives_expected"] or m["decode_collectives"] != m["decode_collectives_expected"]:
            failed.append(f"{name}: collectives {counts} != {m['collectives_expected']}")
        if not m["finite"] or m["steps"] != steps:
            failed.append(f"{name}: finite {m['finite']}, steps {m['steps']}")
        if sizes == (1, 1, 1):
            if not (m["eval_equal"] and m["clip_equal"]) or m["exact_clip_psnr_db"] != math.inf:
                failed.append(f"{name}: not equal bit for bit to the unmeshed clip")
        elif not rehearse:
            # the limits are set for full width (the tiny config's int8
            # buckets flip more often), as the gradcheck's are
            floor = recs[0]["one_card"]["plain_attention_clip_psnr_db"] - MESH_INT8_CLIP_MARGIN_DB
            if min(m["eval_psnr_db"], m["exact_eval_psnr_db"]) < MESH_EVAL_PSNR_MIN \
                    or m["exact_clip_psnr_db"] < MESH_CLIP_PSNR_MIN or m["clip_psnr_db"] < floor:
                failed.append(f"{name}: PSNR eval {m['eval_psnr_db']:.1f} (exact {m['exact_eval_psnr_db']:.1f}), "
                              f"clip {m['clip_psnr_db']:.1f} (one card's own {floor + MESH_INT8_CLIP_MARGIN_DB:.1f}), "
                              f"exact clip {m['exact_clip_psnr_db']:.1f} dB")
        lines.append(m)
    daemon = None
    if cards >= 4 and not rehearse:
        daemon = _mesh_daemon(ckpt, model_cfg, "2,1,2")
        if daemon["served"] != 2 or any(not r.get("ok") for r in daemon["results"].values()) \
                or any(v != [1, frames, size, size, 3] for v in daemon["finite_shapes"].values()):
            failed.append(f"daemon: {daemon}")
    # the counts the formula gives at the JAX CPU-sim audit's mesh (data 2 x
    # seq 4, MULTICHIP_AUDIT_CPUSIM_INFER.json), for the comparison
    from i2v_adapter_tpu_torch.parallel.audit import collectives_per_unet_eval

    at_jax_mesh = collectives_per_unet_eval(model_cfg.unet, {"data": 2, "fsdp": 1, "tensor": 1, "seq": 4}, 2,
                                            frames, latent, True, True)
    emit({"phase": "mesh", "ranks": ranks, "cards": cards, "size": size, "frames": frames, "steps": steps,
          "seconds": seconds, "one_card": recs[0]["one_card"], "meshes": lines, "daemon": daemon,
          "formula_at_data2_seq4": at_jax_mesh, "nvlink_bytes_per_s": PEAK_NVLINK_BYTES,
          "limits": {"eval_psnr_db": MESH_EVAL_PSNR_MIN, "exact_clip_psnr_db": MESH_CLIP_PSNR_MIN,
                     "int8_clip_margin_db": MESH_INT8_CLIP_MARGIN_DB}})
    if failed:
        raise AssertionError(f"mesh: {failed}")
    # rank 0's launches over the meshes' clips
    return {k: sum(m["clip_launches"][k] for m in recs[0]["meshes"]) for k in KERNELS}


# the mesh_train phase: the train step over a mesh of ranks, one per card
MESH_TRAIN_STEPS = 2  # one card: two steps beside the unmeshed ones
MESH_TRAIN_TIMED_STEPS = 5  # four cards: step ms is the mean of steps 2-5
MESH_TRAIN_MICRO_CLIPS = 2  # the one-card reference's micro-batch
MESH_TRAIN_TIMEOUT_S = 900


def mesh_train_cases(cards: int, rehearse: bool) -> list:
    """The phase's meshes: ``(name, (data, fsdp, tensor, seq), fsdp_frozen,
    size, clips per data x fsdp way, motion modules trained)``.  On four
    cards the JAX audit's train meshes that fit them (config 4 at 256 px,
    2 clips a way; the 512 px motion finetune at 1 clip a way); on one card
    the (1,1,1,1) mesh; two gloo ranks in the rehearsal."""
    if rehearse:
        return [("1,2,1,1", (1, 2, 1, 1), "shard", 32, 1, False),
                ("1,1,1,2", (1, 1, 1, 2), "shard", 32, 1, False)]
    if cards >= 4:
        from i2v_adapter_tpu_torch.tools.audit_multichip import TRAIN_CASES

        return [(name,) + case for name, case in TRAIN_CASES.items()]
    return [("1,1,1,1", (1, 1, 1, 1), "shard", 256, 2, False)]


def mesh_train_launches_per_step(model_cfg, latent: int, tcfg, seq: int) -> dict:
    """One rank's kernel launches for one meshed train step: K1, K3 and the
    GroupNorm kernel as on one card (each site runs once on the rank's
    slab; the key counts are the spatial tokens, which no axis splits; the
    motion norms, which ``seq`` splits, carry gradients), K2 at the motion
    modules whose local token count (S / seq when the frames and the tokens
    split, else S) reaches 128, in the forward and its recompute."""
    ucfg = model_cfg.unet
    per = dict(launches_per_train_step(model_cfg, latent, tcfg))
    split = seq > 1 and tcfg.num_frames % seq == 0
    n = ucfg.num_blocks
    levels = [(latent >> i, ucfg.layers_per_block, ucfg.use_motion_modules) for i in range(n)]
    levels.append((latent >> (n - 1), 1, ucfg.use_motion_modules and ucfg.use_motion_mid_block))
    levels += [(latent >> (n - 1 - i), ucfg.layers_per_block + 1, ucfg.use_motion_modules) for i in range(n)]
    temporal = 0
    for h, layers, motion in levels:
        tokens = h * h
        local = tokens // seq if split and tokens % seq == 0 else tokens
        temporal += 2 * layers if motion and local >= 128 else 0
    per["temporal_attention_cs"] = temporal * (2 if tcfg.gradient_checkpointing else 1)
    return per


def _mesh_train_config(case, rehearse: bool):
    from i2v_adapter_tpu_torch.config import MeshConfig, reference_train_config

    _, sizes, frozen, size, clips, motion = case
    tc = reference_train_config().replace(
        train_batch_size=clips * sizes[0] * sizes[1], resolution=size, update_motion_modules=motion,
        fsdp_frozen=frozen, mesh=MeshConfig(*sizes), uncond_prob_t=0.1, uncond_prob_i=0.1)
    if rehearse:
        tc = tc.replace(num_frames=4, mixed_precision="none", freeze_dtype="float32")
    return tc


def _whole_grads(state, grads: dict) -> dict:
    """The trainables' gradients whole (blocks gathered; every rank calls)."""
    from i2v_adapter_tpu_torch.training.checkpoint import state_entries

    if state.zero is None:
        return grads
    names = {param: name for name, _, _, _, param in state_entries(state) if name.startswith("trainable/")}
    return {n: state.zero.gather(names[n], g) for n, g in grads.items()}


def _mesh_train_reference(model_cfg, tc, batch, draws, dev, one_card: bool) -> dict:
    """One card's gradients of the global batch: on the (1,1,1,1) mesh the
    unmeshed step's (twice, to see whether the kernels' sums repeat bit for
    bit) and its two steps; over several cards the weighted sum of its
    micro-batches of ``MESH_TRAIN_MICRO_CLIPS`` clips (the global loss is a
    mean over clips)."""
    from i2v_adapter_tpu_torch.training import make_train_step
    from i2v_adapter_tpu_torch.training.train_i2v import local_draws
    from i2v_adapter_tpu_torch.utils.random_init import random_train_state

    state = random_train_state(model_cfg, tc, dev, seed=1)
    step = make_train_step(model_cfg, tc, device=dev)
    b, f = tc.train_batch_size, tc.num_frames
    if one_card:
        loss, grads = step.loss_and_grads(state, batch, draws)
        again = step.loss_and_grads(state, batch, draws)
        repeats = bool(torch.equal(loss, again[0]) and all(torch.equal(grads[n], again[1][n]) for n in grads))
        losses, step_ms = [], []
        for i in range(MESH_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch, draws=draws if i == 0 else None)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"])
        return {"loss": loss, "grads": grads, "repeats_bit_for_bit": repeats, "losses": losses,
                "step_ms": step_ms,
                "trainables": {n: p.detach().clone() for n, p in state.trainable_params().items()}}
    grads, loss = None, 0.0
    micro = MESH_TRAIN_MICRO_CLIPS
    for lo in range(0, b, micro):
        hi = min(lo + micro, b)
        part = {k: v[lo:hi] for k, v in batch.items()}
        l_mb, g_mb = step.loss_and_grads(state, part, local_draws(draws, (lo, hi), (0, f)))
        w = (hi - lo) / b
        loss = loss + w * float(l_mb)
        grads = {n: w * g for n, g in g_mb.items()} if grads is None else {n: grads[n] + w * g_mb[n]
                                                                             for n in grads}
    return {"loss": loss, "grads": grads}


def _mesh_train_rank(cases, model_cfg, rehearse: bool) -> list:
    """One rank of the mesh_train phase: per case the state placed over the
    mesh (seeded random weights, the same on every rank), the first step's
    loss and gradients against one card's on the same global batch and
    draws (computed on rank 0 first), then the steps: on one card
    ``MESH_TRAIN_STEPS`` beside the unmeshed ones, over several cards 1 +
    ``MESH_TRAIN_TIMED_STEPS`` timed and one more recorded for the
    collectives; this rank's launches per step and peak memory."""
    import torch.distributed as dist

    from i2v_adapter_tpu_torch.config import MeshConfig
    from i2v_adapter_tpu_torch.ops import launches
    from i2v_adapter_tpu_torch.parallel.mesh import create_mesh, local_batch
    from i2v_adapter_tpu_torch.tools.audit_multichip import audit_train_step
    from i2v_adapter_tpu_torch.training import make_train_step
    from i2v_adapter_tpu_torch.utils.random_init import random_train_batch, random_train_state

    dev = torch.device("cpu") if rehearse else torch.device("cuda", torch.cuda.current_device())
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    recs = []
    for case in cases:
        name, sizes = case[0], case[1]
        tc = _mesh_train_config(case, rehearse)
        mesh = create_mesh(MeshConfig(*sizes), device=dev)
        one_card = mesh.size(("data", "fsdp", "tensor", "seq")) == 1
        batch = random_train_batch(model_cfg, tc, dev, seed=0)
        draws = make_train_step(model_cfg, tc, device=dev).draws(
            None, batch, torch.Generator(device=dev).manual_seed(tc.seed))
        ref = None
        if mesh.rank == 0:
            ref = _mesh_train_reference(model_cfg, tc, batch, draws, dev, one_card)
        if mesh.control is not None:
            dist.barrier(group=mesh.control)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        state = random_train_state(model_cfg, tc, dev, seed=1, mesh=mesh)
        step = make_train_step(model_cfg, tc, mesh=mesh)
        local = local_batch(batch, mesh)
        loss, grads = step.loss_and_grads(state, local, draws)
        grads = _whole_grads(state, grads)
        rec = {"mesh": name, "sizes": list(sizes), "fsdp_frozen": tc.fsdp_frozen, "resolution": tc.resolution,
               "global_batch": tc.train_batch_size, "motion": tc.update_motion_modules, "loss": float(loss)}
        if ref is not None:
            rec["reference_loss"] = float(ref["loss"])
            rec["grad_errors"] = grad_errors(grads, ref["grads"])
            if one_card:
                rec["repeats_bit_for_bit"] = ref["repeats_bit_for_bit"]
                rec["unmeshed_step_ms"] = ref["step_ms"]
                rec["grads_bit_for_bit"] = bool(torch.equal(loss, ref["loss"]) and all(
                    torch.equal(grads[n], ref["grads"][n]) for n in grads))
        del grads
        steps = MESH_TRAIN_STEPS if one_card else 1 + MESH_TRAIN_TIMED_STEPS
        launches.reset()
        step_ms, losses = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, local, draws=draws if i == 0 else None)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"])
        rec["launches"] = launch_counts()
        rec["steps"] = steps
        rec["step_ms"] = step_ms
        rec["losses"] = [float(x) for x in losses]
        if one_card and ref is not None:
            after = state.trainable_params()
            rec["steps_bit_for_bit"] = bool(all(torch.equal(a, b) for a, b in zip(losses, ref["losses"])) and all(
                torch.equal(after[n].detach(), ref["trainables"][n]) for n in after))
        if not one_card:
            rec["step_ms_mean_2_5"] = float(np.mean(step_ms[1:]))
            audit = audit_train_step(state, step, local, mesh, model_cfg, tc, warm_up=False)
            rec["collectives"] = {k: {"count": v["count"], "bytes": v["out_bytes"], "ms": v["ms"],
                                      "wire_bytes_per_device": v["wire_bytes_per_device"],
                                      "bound_ms": v["wire_bytes_per_device"] / PEAK_NVLINK_BYTES * 1e3}
                                  for k, v in audit["summary"]["by_kind"].items()}
            rec["collectives_ms_per_step"] = audit["summary"]["ms"]
            rec["collectives_expected"] = audit["expected"]
        rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
        recs.append(rec)
        del state, step, ref
        if cuda:
            torch.cuda.empty_cache()
    return recs


def phase_mesh_train(model_cfg, dev, rehearse: bool):
    """The train step over a mesh of ranks, one per visible card, spawned by
    ``parallel.launch.run_ranks``: per case of ``mesh_train_cases`` the
    first step's loss and every trainable gradient against one card's on
    the same global batch and draws (on the (1,1,1,1) mesh the unmeshed
    step's, equal bit for bit unless the unmeshed step itself does not
    repeat bit for bit, then within the ``gradcheck`` limits; over several
    cards the weighted sum of one card's micro-batches, within the
    ``gradcheck`` limits), each rank's K1 / K2 / K3 launches per step
    against ``mesh_train_launches_per_step``, peak memory, step ms and,
    over several cards, one step's collectives (count, bytes, ms) against
    ``collectives_per_train_step``.  Any rank failing or hanging fails the
    phase."""
    from i2v_adapter_tpu_torch.parallel.launch import run_ranks

    cards = 2 if rehearse else torch.cuda.device_count()
    cases = mesh_train_cases(cards, rehearse)
    ranks = int(np.prod(cases[0][1]))
    if not rehearse:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = run_ranks(_mesh_train_rank, ranks, (cases, model_cfg, rehearse), device="cpu" if rehearse else None,
                     timeout=MESH_TRAIN_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    failed, lines = [], []
    for i, case in enumerate(cases):
        per = [r[i] for r in recs]
        m = dict(per[0])
        tc = _mesh_train_config(case, rehearse)
        latent = tc.resolution // model_cfg.vae.spatial_scale_factor
        per_step = mesh_train_launches_per_step(model_cfg, latent, tc, case[1][3])
        want = expected_counts(**{k: 0 if rehearse else m["steps"] * v for k, v in per_step.items()})
        m.update(launches_per_rank=[r["launches"] for r in per], expected_launches=want,
                 launches_per_step=per_step, peak_gb_per_rank=[r["peak_gb"] for r in per],
                 step_ms_per_rank=[r["step_ms"] for r in per])
        for key in ("launches", "peak_gb"):
            m.pop(key, None)
        name = m["mesh"]
        if any(r["launches"] != want for r in per):
            failed.append(f"{name}: launches per rank {[r['launches'] for r in per]} != {want}")
        if not all(math.isfinite(x) for x in m["losses"]):
            failed.append(f"{name}: losses {m['losses']}")
        if "collectives" in m:
            counts = {k: v["count"] for k, v in m["collectives"].items()}
            if counts != m["collectives_expected"]:
                failed.append(f"{name}: collectives {counts} != {m['collectives_expected']}")
        e = m["grad_errors"]
        if m.get("repeats_bit_for_bit", False):
            if not (m["grads_bit_for_bit"] and m["steps_bit_for_bit"]):
                failed.append(f"{name}: not equal bit for bit to the unmeshed step ({e})")
        elif not rehearse and not within_grad_limits(e):
            failed.append(f"{name}: gradients against one card outside the gradcheck limits ({e})")
        elif not math.isfinite(e["rel_l2"]):
            failed.append(f"{name}: non-finite gradients ({e})")
        lines.append(m)
    emit({"phase": "mesh_train", "ranks": ranks, "cards": cards, "seconds": seconds, "cases": lines,
          "nvlink_bytes_per_s": PEAK_NVLINK_BYTES,
          "limits": {"rel_l2_max": GRAD_REL_L2_MAX, "leaf_rel_l2_max": GRAD_LEAF_REL_L2_MAX,
                     "cosine_min": GRAD_COSINE_MIN}})
    if failed:
        raise AssertionError(f"mesh_train: {failed}")
    # rank 0's launches over the cases' steps
    return {k: sum(r["launches"][k] for r in recs[0]) for k in KERNELS}


# the driver phase: clips written in the WebVid layout, trained on through
# training/driver.py and served from what it wrote
DRIVER_TASK = "driver_task"
DRIVER_CLIPS = 12  # 6 steps of 2 clips: the first run is one epoch
DRIVER_STEPS = 6
DRIVER_CHECKPOINTING_STEPS = 3
DRIVER_RESUME_STEPS = 3
DRIVER_T2I_STEPS = 2


def _write_clips(folder: str, n: int, frames: int, width: int, height: int) -> dict:
    """``n`` clips of ``frames`` random frames at ``width`` x ``height`` as
    ``<folder>/p<i % 3>/v<i>.mp4`` (OpenCV's mp4v writer) and a CSV of
    them; the dataset decodes them with OpenCV, so a host without it or its
    mp4 writer fails the phase here."""
    import cv2

    rng = np.random.default_rng(21)
    rows = []
    for i in range(n):
        page, vid = f"p{i % 3}", f"v{i}"
        os.makedirs(os.path.join(folder, page), exist_ok=True)
        # a moving gradient under noise, so the resize and the flip see structure
        base = np.linspace(0, 255, width, dtype=np.float32)[None, :, None]
        path = os.path.join(folder, page, vid + ".mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8, (width, height))
        if not w.isOpened():
            raise RuntimeError(f"OpenCV {cv2.__version__} cannot write mp4v to {path}")
        for t in range(frames):
            w.write(np.clip(np.roll(base, 3 * t, axis=1) + rng.normal(0, 24, (height, width, 3)), 0, 255)
                    .astype(np.uint8))
        w.release()
        rows.append(f"{vid},clip number {i},{page}")
    csv_path = os.path.join(folder, "train.csv")
    with open(csv_path, "w") as f:
        f.write("videoid,name,page_dir\n" + "\n".join(rows) + "\n")
    return {"csv": csv_path, "cv2": cv2.__version__}


@contextlib.contextmanager
def _driver_probes(per_step: list, snapshots: dict, checks: dict):
    """Around the driver: launches read before and after every train step
    (``per_step``); the train state copied to the host after each full-state
    save (``snapshots``, the last one kept) and held against the state
    right after a restore, every leaf bit for bit (``checks``, with the
    restore's and each validation's seconds, and in ``probe_s`` the seconds
    of each copy and comparison, which are the smoke's, not the driver's)."""
    from i2v_adapter_tpu_torch.training import checkpoint as ckpt_mod
    from i2v_adapter_tpu_torch.training import driver

    real_make, real_save, real_restore, real_validation = (
        driver.make_train_step, ckpt_mod.TrainCheckpointer.save, ckpt_mod.TrainCheckpointer.restore,
        driver._run_validation)

    def make_train_step(*a, **k):
        step_fn = real_make(*a, **k)

        def counted(state, batch, *rest, **kw):
            before = launch_counts()
            out = step_fn(state, batch, *rest, **kw)
            after = launch_counts()
            per_step.append({name: after[name] - before[name] for name in after})
            return out
        return counted

    def save(self, step, state):
        real_save(self, step, state)
        t0 = time.perf_counter()
        snapshots.clear()
        snapshots.update({k: v.to("cpu", copy=True) for k, v in ckpt_mod.train_state_tensors(state).items()})
        snapshots["counters"] = dict(ckpt_mod._counters(state))
        checks.setdefault("probe_s", []).append(time.perf_counter() - t0)

    def restore(self, state, step=None):
        t0 = time.perf_counter()
        out = real_restore(self, state, step)
        t1 = time.perf_counter()
        checks["restore_s"] = t1 - t0
        live = ckpt_mod.train_state_tensors(state)
        want = {k: v for k, v in snapshots.items() if k != "counters"}
        checks["restored_leaves"] = len(live)
        checks["restored_mismatched"] = sorted(
            set(want) ^ set(live) | {k for k in live if k in want and not torch.equal(live[k].cpu(), want[k])})
        checks["restored_counters_equal"] = ckpt_mod._counters(state) == snapshots.get("counters")
        checks.setdefault("probe_s", []).append(time.perf_counter() - t1)
        return out

    def validation(*a, **k):
        t0 = time.perf_counter()
        out = real_validation(*a, **k)
        checks.setdefault("validation_s", []).append(time.perf_counter() - t0)
        return out

    driver.make_train_step, driver._run_validation = make_train_step, validation
    ckpt_mod.TrainCheckpointer.save, ckpt_mod.TrainCheckpointer.restore = save, restore
    try:
        yield
    finally:
        driver.make_train_step, driver._run_validation = real_make, real_validation
        ckpt_mod.TrainCheckpointer.save, ckpt_mod.TrainCheckpointer.restore = real_save, real_restore


def _driver_run(argv, model_cfg, rehearse: bool, per_step: list, checks: dict) -> dict:
    """``driver.main(argv)`` with the launch counts set to 0 just before it
    and read just after; its result, counts, seconds (with and without the
    probes' copies and comparisons) and the card's peak."""
    import gc

    from i2v_adapter_tpu_torch.training import driver

    gc.collect()
    if not rehearse:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    del per_step[:]
    probe_before = sum(checks.get("probe_s", []))
    reset_launch_counts()
    t0 = time.perf_counter()
    result = driver.main(argv, model_config=model_cfg)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    probe_s = sum(checks.get("probe_s", [])) - probe_before
    return {"result": result, "launches": counts, "seconds": seconds, "probe_s": probe_s,
            "seconds_without_probes": seconds - probe_s, "per_step": list(per_step),
            "gpu_peak_memory_gb": None if rehearse else torch.cuda.max_memory_allocated() / 1e9}


def _run_summary(run: dict, expected_step: dict) -> dict:
    r = run["result"]
    return {
        "seconds": run["seconds"], "probe_s": run["probe_s"], "seconds_without_probes": run["seconds_without_probes"],
        "global_step": r["global_step"], "losses": r["losses"],
        "grad_norms": r["grad_norms"], "skipped_nonfinite": sum(r["skipped_nonfinite"]),
        "step_ms": [s * 1e3 for s in r["step_s"]],
        "step_ms_after_first": _spread([s * 1e3 for s in r["step_s"][1:]]),
        "data_wait_ms": [s * 1e3 for s in r["data_wait_s"]],
        "data_wait_ms_after_first": _spread([s * 1e3 for s in r["data_wait_s"][1:]]),
        "state_saves": r["state_saves"], "gpu_peak_memory_gb": run["gpu_peak_memory_gb"],
        "launches": run["launches"], "launches_per_step": run["per_step"],
        "expected_launches_per_step": expected_step,
        "launches_per_step_as_derived": all(s == expected_step for s in run["per_step"]),
    }


def _spread(xs) -> dict:
    return {"n": len(xs), "mean": float(np.mean(xs)) if xs else None,
            "min": float(np.min(xs)) if xs else None, "max": float(np.max(xs)) if xs else None}


def phase_driver(model_cfg, dev, rehearse: bool, ckpt: dict):
    """``training/driver.py``'s ``main`` on the full-width directory at the
    reference training workload (2 clips x 16 frames at 256 px, bf16, frozen
    weights in bf16, activation checkpointing, AdamW, EMA) over clips
    written in the WebVid layout (64 frames at 336 x 256, stride 4): 6
    steps (one epoch) with full-state saves at steps 3 and 6, the epoch's
    adapter checkpoint and a validation sample; then
    ``--resume_from_checkpoint latest`` for 3 more steps, the restored
    state equal to the saved one bit for bit, its save at step 9
    asynchronous; the newest epoch checkpoint loaded by ``from_pretrained``
    at the serving default (its adapter equal to the trained EMA in bf16)
    and one 5-step request served; ``load_pipeline_params`` of the final
    export; then 2 steps of ``--train_mode t2i``.  Every train step's K1,
    K2 and K3 launches are held to ``launches_per_train_step``, with no
    int8 launch.  Returns the launches of the i2v runs and of the t2i run."""
    from i2v_adapter_tpu_torch.config import PipelineConfig, reference_train_config
    from i2v_adapter_tpu_torch.data import native
    from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
    from i2v_adapter_tpu_torch.pipelines.serve import adapter_checkpoint
    from i2v_adapter_tpu_torch.training.checkpoint import load_pipeline_params
    from i2v_adapter_tpu_torch.utils import convert
    from i2v_adapter_tpu_torch.utils.safetensors_io import load_file

    tcfg = reference_train_config()
    size, frames, clip_w, clip_h, clip_frames = DRIVER_RESOLUTION, tcfg.num_frames, 336, 256, 64
    if rehearse:
        size, frames, clip_w, clip_h, clip_frames = 32, 4, 48, 40, 16
    folder, out_dir = os.path.join(WORK_DIR, "webvid"), os.path.join(WORK_DIR, "train_out")
    data = _write_clips(folder, DRIVER_CLIPS, clip_frames, clip_w, clip_h)
    eval_csv = os.path.join(WORK_DIR, "train_eval.csv")
    with open(eval_csv, "w") as f:
        f.write(f"prompt,image_path\na moving gradient,{_condition_image(size)}\n")
    common = ["--pretrained_model_path", ckpt["root"], "--csv_path", data["csv"], "--video_folder", folder,
              "--output_dir", out_dir, "--resolution", str(size), "--n_frames", str(frames),
              "--train_batch_size", str(tcfg.train_batch_size), "--gradient_accumulation_steps", "1",
              "--mixed_precision", "none" if rehearse else "bfloat16", "--freeze_dtype", "bfloat16",
              "--gradient_checkpointing", "--num_workers", "4", "--seed", "0"]
    if rehearse:
        common += ["--device", "cpu"]
    i2v = common + ["--task_name", DRIVER_TASK, "--train_mode", "i2v", "--use_ema",
                    "--checkpointing_steps", str(DRIVER_CHECKPOINTING_STEPS), "--checkpoints_total_limit", "2",
                    "--checkpoint_epoch", "1"]
    latent = size // model_cfg.vae.spatial_scale_factor
    zero = expected_counts()
    want_i2v = zero if rehearse else expected_counts(**launches_per_train_step(model_cfg, latent, tcfg))
    t2i_cfg = model_cfg.replace(unet=model_cfg.unet.replace(
        use_motion_modules=False, use_i2v_adapter=False, use_ip_adapter=False))
    want_t2i = zero if rehearse else expected_counts(**launches_per_train_step(
        t2i_cfg, latent, tcfg.replace(train_mode="t2i")))

    per_step, snapshots, checks, failed = [], {}, {}, []
    with _driver_probes(per_step, snapshots, checks):
        first = _driver_run(i2v + ["--max_train_steps", str(DRIVER_STEPS), "--validation_epoch", "1",
                                   "--eval_csv_path", eval_csv], model_cfg, rehearse, per_step, checks)
        resumed = _driver_run(i2v + ["--max_train_steps", str(DRIVER_STEPS + DRIVER_RESUME_STEPS),
                                     "--resume_from_checkpoint", "latest", "--async_checkpoint"],
                              model_cfg, rehearse, per_step, checks)
        t2i = _driver_run(common + ["--task_name", "driver_t2i", "--train_mode", "t2i", "--checkpoint_epoch", "2",
                                    "--max_train_steps", str(DRIVER_T2I_STEPS)], model_cfg, rehearse, per_step, checks)
    snapshots.clear()
    task_dir = os.path.join(out_dir, DRIVER_TASK)
    gif = os.path.join(task_dir, "samples_epoch_1", "sample_0_0.gif")

    # serve what was trained: the newest epoch checkpoint at the serving default
    adapter = adapter_checkpoint(out_dir, DRIVER_TASK, None)
    pipe = I2VAdapterPipeline.from_pretrained(ckpt["root"], model_config=model_cfg, pipeline_config=PipelineConfig(),
                                              i2v_adapter_path=adapter, device=dev)
    state_file = os.path.join(task_dir, "state", f"step_{DRIVER_STEPS + DRIVER_RESUME_STEPS}.safetensors")
    ema = {k[len("ema/"):]: v for k, v in load_file(state_file).items() if k.startswith("ema/")}
    want = convert.extract_i2v_adapter(convert._unflatten(ema))
    served = {n: p.detach() for n, p in pipe.unet.named_parameters() if ".i2v_adapter." in n}
    got = convert.extract_i2v_adapter(convert.to_flax_tree(pipe.unet, served))
    # the trained leaves (to_q, to_out); the adapter's K / V stay tied to attn1
    adapter_mismatched = sorted(k for k in want if k not in got or not np.array_equal(
        got[k], torch.from_numpy(want[k]).to(pipe.dtype).float().numpy()))
    t0 = time.perf_counter()
    from PIL import Image

    video = pipe("a moving gradient", condition_image=Image.open(_condition_image(size)), num_frames=frames,
                 height=size, width=size, num_inference_steps=5, seed=0)
    request_s = time.perf_counter() - t0
    del pipe, served
    exported = load_pipeline_params(os.path.join(task_dir, "pipeline"))
    export_leaves = {name: len(convert.flatten_tree(tree)) for name, tree in exported.items()}
    del exported

    runs = {"i2v": _run_summary(first, want_i2v), "resumed": _run_summary(resumed, want_i2v),
            "t2i": _run_summary(t2i, want_t2i)}
    line = {"phase": "driver", "clips": DRIVER_CLIPS, "clip_frames": clip_frames, "clip_size": [clip_w, clip_h],
            "decode": "cv2", "cv2": data["cv2"],
            "preprocess": "native" if native.available() else "numpy", "runs": runs,
            "restore": {k: v for k, v in checks.items() if k not in ("validation_s", "probe_s")},
            "probe_s": checks.get("probe_s"),
            "validation_s": checks.get("validation_s"), "validation_gif": os.path.exists(gif),
            "served_adapter": adapter, "served_adapter_leaves": len(want),
            "served_adapter_mismatched": adapter_mismatched, "served_request_s": request_s,
            "served_shape": list(video.shape), "served_range": [int(video.min()), int(video.max())],
            "export_leaves": export_leaves}
    emit(line)
    for name, run in runs.items():
        n = {"i2v": DRIVER_STEPS, "resumed": DRIVER_RESUME_STEPS, "t2i": DRIVER_T2I_STEPS}[name]
        if len(run["losses"]) != n:
            failed.append(f"{name}: {len(run['losses'])} steps, not {n}")
        if not all(math.isfinite(x) for x in run["losses"] + run["grad_norms"]) or run["skipped_nonfinite"]:
            failed.append(f"{name}: losses {run['losses']}, grad norms {run['grad_norms']}")
        if not run["launches_per_step_as_derived"]:
            failed.append(f"{name}: launches per step {run['launches_per_step']} != {run['expected_launches_per_step']}")
    # the int8 launches: the first run's validation clip only (the shapes
    # phase_kernels holds against their plain versions), none elsewhere
    int8_names = ("int8_conv3x3_kernel", "int8_matmul", "quantize_weights")
    want_val = {k: 0 for k in int8_names} if rehearse else validation_int8_launches(model_cfg, latent)
    for name, want_int8 in (("i2v", want_val), ("resumed", {k: 0 for k in int8_names}),
                            ("t2i", {k: 0 for k in int8_names})):
        got_int8 = {k: runs[name]["launches"][k] for k in int8_names}
        if got_int8 != want_int8:
            failed.append(f"{name}: int8 launches {got_int8} != {want_int8}")
    if runs["resumed"]["global_step"] != DRIVER_STEPS + DRIVER_RESUME_STEPS:
        failed.append(f"resumed: global step {runs['resumed']['global_step']}")
    if checks.get("restored_mismatched") != [] or not checks.get("restored_counters_equal"):
        failed.append(f"restore: {checks}")
    if [s["step"] for s in runs["i2v"]["state_saves"]] != [3, 6]:
        failed.append(f"state saves {runs['i2v']['state_saves']}")
    if not line["validation_gif"] or adapter is None or adapter_mismatched or not want:
        failed.append(f"served: gif {line['validation_gif']}, adapter {adapter}, mismatched {adapter_mismatched[:4]}")
    if line["served_shape"] != [1, frames, size, size, 3] or not line["served_range"][1] > line["served_range"][0]:
        failed.append(f"served request: {line['served_shape']} {line['served_range']}")
    want_models = {"unet", "vae", "text_encoder", "image_encoder"}
    if set(export_leaves) != want_models:
        failed.append(f"export: {export_leaves}")
    if failed:
        raise AssertionError(f"driver: {failed}")
    i2v_counts = {k: first["launches"][k] + resumed["launches"][k] for k in first["launches"]}
    return i2v_counts, t2i["launches"]


def _write_images(folder: str, n: int, rehearse: bool) -> None:
    """``n`` PNGs (a gradient under noise, 600 x 520, or 80 x 72 in
    rehearsal) in two class folders."""
    from PIL import Image

    rng = np.random.default_rng(31)
    w, h = (80, 72) if rehearse else (600, 520)
    base = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
    for i in range(n):
        cls = os.path.join(folder, ("red", "blue")[i % 2])
        os.makedirs(cls, exist_ok=True)
        img = np.clip(np.roll(base, 7 * i, axis=1) + rng.normal(0, 24, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(cls, f"img{i:02d}.png"))


def _embeds_by_caption(captions_path: str, embeds_path: str) -> dict:
    with open(captions_path) as f:
        captions = f.read().split("\n")
    embeds = np.load(embeds_path)
    if len(captions) != len(embeds):
        raise AssertionError(f"{len(captions)} captions vs {len(embeds)} text embeddings")
    return {c: embeds[i].astype(np.float32) for i, c in enumerate(captions)}


def _timed_steps(step_fn, opt, batches, sync):
    """Run ``step_fn`` over ``batches``: per step the synchronised ms, the
    loss and the launches (counts set to 0 before it and read after)."""
    out = []
    for batch in batches:
        reset_launch_counts()
        t0 = time.perf_counter()
        opt, loss = step_fn(opt, batch)
        sync()
        out.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": float(loss), "launches": launch_counts()})
    return opt, out


def phase_latent(model_cfg, dev, rehearse: bool, ckpt: dict) -> dict:
    """The latent-diffusion zoo on the card, end to end: the offline
    encoders on the ``pretrained`` directory (full width, fp16) write
    4 clips' latents (64 frames at 336 x 256, encoded at 256 px in slices
    of 16), 16 PNGs' latents at 256 and 512 px and the captions' CLIP
    embeddings; SimpleUNet3D (defaults, fp32) trains on the video latents
    (2 clips x 16 frames with text, 1 warm-up + 4 timed steps), then 2
    ``image_only`` steps on single frames; SimpleUNet trains on the 512 px
    image latents (batch 8, 1 + 4 steps); both sample with CFG 7.5 over all
    1000 timesteps, each step replayed from a CUDA graph, and again through
    the eager loop (``_sample_latents_eager``) on the same draws, equal bit
    for bit; one SimpleUNetDome forward at (8, 64, 64, 3); each
    trained UNet's checkpoint written, read into a fresh model and compared
    bit for bit.  Every step's, sampler's and forward's K1 / K3 launches are
    held to ``launches_per_simple_eval``, the GroupNorm kernel's to
    ``module_group_norms`` (the samplers and the dome: no gradient; none in
    the steps, where every weight trains), no other kernel launching; the
    losses finite, every parameter moved, the samples finite.  Returns the
    phase's launches (the steps, samplers and dome)."""
    from i2v_adapter_tpu_torch.data.latent import LatentImageDataset, LatentVideoDataset
    from i2v_adapter_tpu_torch.models.simple import SimpleUNet, SimpleUNet3D, SimpleUNetDome
    from i2v_adapter_tpu_torch.tools import encode_image, encode_text, encode_video
    from i2v_adapter_tpu_torch.training.train_latent import (
        LATENT_SCHEDULE,
        _sample_latents_eager,
        load_simple_checkpoint,
        make_latent_train_step,
        make_video_latent_train_step,
        sample_latents,
        save_simple_checkpoint,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the zoo is fp32, as in JAX
    torch.backends.cudnn.allow_tf32 = False
    work, root = os.path.join(WORK_DIR, "latent"), ckpt["root"]
    zoo, timesteps = LATENT_ZOO, LATENT_SAMPLE_TIMESTEPS
    video_size, image_sizes, clip_frames = LATENT_VIDEO_SIZE, LATENT_IMAGE_SIZES, LATENT_CLIP_FRAMES
    clip_w, clip_h = 336, 256
    dome_batch, frames = LATENT_DOME_BATCH, LATENT_FRAMES
    if rehearse:  # the tiny VAE halves, not eighths; narrow zoo, short schedule
        zoo, timesteps = {"widths": (16, 32), "attention_levels": (False, True), "heads": 2}, 24
        video_size, image_sizes, clip_w, clip_h, clip_frames = 32, (32, 64), 48, 40, 16
        dome_batch, frames = 1, 4
    device_flag = ["--device", "cpu"] if rehearse else []
    sync = (lambda: None) if rehearse else torch.cuda.synchronize
    schedule = LATENT_SCHEDULE.replace(num_train_timesteps=timesteps)
    ctx_dim = model_cfg.text_encoder.hidden_size
    failed, timings = [], {}
    if not rehearse:
        torch.cuda.reset_peak_memory_stats()

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        timings[name] = time.perf_counter() - t0
        return out

    # -- the offline encoders --------------------------------------------
    _write_clips(os.path.join(work, "videos"), LATENT_CLIPS, clip_frames, clip_w, clip_h)
    _write_images(os.path.join(work, "images"), LATENT_IMAGES, rehearse)
    vid_dir = os.path.join(work, "video_latents")
    timed("encode_video_s", lambda: encode_video.encode_videos(
        ["--video_folder", os.path.join(work, "videos"), "--vae_path", os.path.join(root, "vae"), "--output_dir",
         vid_dir, "--sample_size", str(video_size), "--slice_frames", "16"] + device_flag, model_config=model_cfg))
    img_dirs = {}
    for size in image_sizes:
        img_dirs[size] = os.path.join(work, f"image_latents_{size}")
        timed(f"encode_image_{size}_s", lambda: encode_image.encode_images(
            ["--image_folder", os.path.join(work, "images"), "--vae_path", os.path.join(root, "vae"),
             "--output_dir", img_dirs[size], "--sample_size", str(size)] + device_flag, model_config=model_cfg))
    text = ["--text_encoder_path", os.path.join(root, "text_encoder"), "--tokenizer_path",
            os.path.join(root, "tokenizer")] + device_flag
    for name, captions in (("video", os.path.join(vid_dir, "prompts.txt")),
                           ("image", os.path.join(img_dirs[image_sizes[1]], "captions.txt"))):
        timed(f"encode_text_{name}_s", lambda: encode_text.encode_text(
            ["--caption_file", captions, "--output_path", os.path.join(work, f"{name}_embeds.npy")] + text,
            model_config=model_cfg))
    factor = model_cfg.vae.spatial_scale_factor
    files = {"video_latents": np.load(os.path.join(vid_dir, "latents.npy"), mmap_mode="r"),
             "frames_per_video": np.load(os.path.join(vid_dir, "frames_per_video.npy")),
             "video_embeds": np.load(os.path.join(work, "video_embeds.npy"), mmap_mode="r"),
             "image_embeds": np.load(os.path.join(work, "image_embeds.npy"), mmap_mode="r"),
             **{f"image_latents_{s}": np.load(os.path.join(d, "latents.npy"), mmap_mode="r")
                for s, d in img_dirs.items()}}
    want_shapes = {"video_latents": (LATENT_CLIPS * clip_frames, video_size // factor, video_size // factor, 4),
                   "frames_per_video": (LATENT_CLIPS,),
                   "video_embeds": (LATENT_CLIPS, model_cfg.text_encoder.max_position_embeddings, ctx_dim),
                   "image_embeds": (LATENT_IMAGES, model_cfg.text_encoder.max_position_embeddings, ctx_dim),
                   **{f"image_latents_{s}": (LATENT_IMAGES, s // factor, s // factor, 4) for s in image_sizes}}
    encoded = {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in files.items()}
    for k, v in files.items():
        if tuple(v.shape) != want_shapes[k] or (v.dtype != np.float16 and k != "frames_per_video") \
                or not np.isfinite(np.asarray(v, np.float32)).all():
            failed.append(f"encoded {k}: {encoded[k]}, want {want_shapes[k]} finite fp16")

    # -- datasets and batches --------------------------------------------
    vds = LatentVideoDataset(os.path.join(vid_dir, "latents.npy"), os.path.join(vid_dir, "frames_per_video.npy"),
                             os.path.join(vid_dir, "prompts.txt"), sample_n_frames=frames, seed=0)
    ids = LatentImageDataset(os.path.join(img_dirs[image_sizes[1]], "latents.npy"),
                             os.path.join(img_dirs[image_sizes[1]], "captions.txt"))
    video_text = _embeds_by_caption(os.path.join(vid_dir, "prompts.txt"), os.path.join(work, "video_embeds.npy"))
    image_text = _embeds_by_caption(os.path.join(img_dirs[image_sizes[1]], "captions.txt"),
                                    os.path.join(work, "image_embeds.npy"))

    def batch_of(items, text_by_caption, lift=lambda z: z):
        return {"latents": torch.from_numpy(np.stack([lift(it["latents"]) for it in items])).to(dev),
                "text_embeds": torch.from_numpy(np.stack([text_by_caption[it["text"]] for it in items])).to(dev)}

    steps = 1 + TRAIN_STEPS
    video_batches = [batch_of([vds[(2 * i + j) % len(vds)] for j in range(LATENT_VIDEO_BATCH)], video_text)
                     for i in range(steps)]
    frame_batches = [batch_of([vds[j] for j in range(LATENT_VIDEO_BATCH)], video_text, lambda z: z[0])
                     for _ in range(LATENT_IMAGE_ONLY_STEPS)]
    image_batches = [batch_of([ids[(LATENT_IMAGE_BATCH * i + j) % len(ids)] for j in range(LATENT_IMAGE_BATCH)],
                              image_text) for i in range(steps)]

    def moved(model, start):
        return sum(not torch.equal(p.detach(), start[n]) for n, p in model.named_parameters())

    def held(name, runs, per_run):
        """Each run's launches against the derivation (K1 / K3 and the
        GroupNorm kernel)."""
        want = expected_counts(**({} if rehearse else per_run))
        bad = [r["launches"] for r in runs if r["launches"] != want]
        if bad:
            failed.append(f"{name}: launches {bad[0]} != {want}")
        return want

    # -- training --------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.manual_seed(0)
    video_lat, image_lat = video_size // factor, image_sizes[1] // factor
    unet3d = SimpleUNet3D(**zoo, context_dim=ctx_dim, device=dev)
    start3d = {n: p.detach().clone() for n, p in unet3d.named_parameters()}
    init_v, step_v = make_video_latent_train_step(unet3d)
    _, step_i = make_video_latent_train_step(unet3d, image_only=True)
    opt_v, video_runs = _timed_steps(lambda o, b: step_v(o, b, gen), init_v(), video_batches, sync)
    opt_v, image_only_runs = _timed_steps(lambda o, b: step_i(o, b, gen), opt_v, frame_batches, sync)
    per_video = launches_per_simple_eval(zoo, video_lat, video=True, frames=frames, train=True)
    held("video step", video_runs, per_video)
    held("image_only step", image_only_runs, launches_per_simple_eval(zoo, video_lat, video=True, frames=1, train=True))
    unet2d = SimpleUNet(**zoo, context_dim=ctx_dim, device=dev)
    start2d = {n: p.detach().clone() for n, p in unet2d.named_parameters()}
    init_fn, step_fn = make_latent_train_step(unet2d)
    _, image_runs = _timed_steps(lambda o, b: step_fn(o, b, gen), init_fn(), image_batches, sync)
    per_image = launches_per_simple_eval(zoo, image_lat, train=True)
    held("image step", image_runs, per_image)
    for name, runs, model, start in (("video", video_runs + image_only_runs, unet3d, start3d),
                                     ("image", image_runs, unet2d, start2d)):
        if not all(math.isfinite(r["loss"]) for r in runs):
            failed.append(f"{name} losses {[r['loss'] for r in runs]}")
        n_moved, n_params = moved(model, start), len(start)
        if n_moved != n_params:
            failed.append(f"{name}: {n_moved} of {n_params} parameters moved")

    # -- sampling ------------------------------------------------------------
    # each sampler replayed from its CUDA graph (the launches counted), then
    # its eager plain version on a generator of the same seed: equal bit for
    # bit, ms a step each way
    samples = {}
    for i, (name, model, shape, ctx) in enumerate((
            ("image", unet2d, (1, video_lat, video_lat, 4), image_batches[0]["text_embeds"][:1]),
            ("video", unet3d, (1, frames, video_lat, video_lat, 4), video_batches[0]["text_embeds"][:1]))):
        kw = dict(context=ctx, guidance_scale=LATENT_GUIDANCE, schedule_config=schedule)
        reset_launch_counts()
        t0 = time.perf_counter()
        x = sample_latents(model, shape, torch.Generator(device=dev).manual_seed(20 + i), **kw)
        sync()
        seconds = time.perf_counter() - t0
        per_step = dict(launches_per_simple_eval(zoo, video_lat, video=name == "video", frames=frames),
                        group_norm_fused=module_group_norms(model))
        want = held(f"{name} sampler", [{"launches": launch_counts()}],
                    {k: timesteps * v for k, v in per_step.items()})
        t0 = time.perf_counter()
        eager = _sample_latents_eager(model, shape, torch.Generator(device=dev).manual_seed(20 + i), **kw)
        sync()
        eager_s = time.perf_counter() - t0
        samples[name] = {"shape": list(x.shape), "seconds": seconds, "ms_per_step": seconds * 1e3 / timesteps,
                         "eager_seconds": eager_s, "eager_ms_per_step": eager_s * 1e3 / timesteps,
                         "equal_to_eager": bool(torch.equal(x, eager)),
                         "max_abs_diff_eager": float((x - eager).abs().max()),
                         "finite": bool(torch.isfinite(x).all()), "std": float(x.float().std()),
                         "launches": want}
        if not samples[name]["finite"]:
            failed.append(f"{name} sample not finite")
        if not samples[name]["equal_to_eager"]:
            failed.append(f"{name} sampler: replay differs from the eager loop by "
                          f"{samples[name]['max_abs_diff_eager']}")

    # -- the dome ---------------------------------------------------------
    dome = SimpleUNetDome(device=dev)
    xd = torch.randn((dome_batch, 64, 64, 3), generator=gen, device=dev)
    td = torch.randint(0, 1000, (dome_batch,), generator=gen, device=dev)
    with torch.no_grad():
        dome(xd, td)
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        yd = dome(xd, td)
        sync()
        dome_ms = (time.perf_counter() - t0) * 1e3
    held("dome forward", [{"launches": launch_counts()}], {"group_norm_fused": module_group_norms(dome)})
    if tuple(yd.shape) != (dome_batch, 64, 64, 3) or not bool(torch.isfinite(yd).all()):
        failed.append(f"dome output {tuple(yd.shape)} finite={bool(torch.isfinite(yd).all())}")

    # -- checkpoints ------------------------------------------------------
    checkpoints = {}
    for name, model, fresh in (("image", unet2d, SimpleUNet(**zoo, context_dim=ctx_dim, device=dev)),
                               ("video", unet3d, SimpleUNet3D(**zoo, context_dim=ctx_dim, device=dev))):
        path = os.path.join(work, f"{name}_unet.safetensors")
        nbytes = save_simple_checkpoint(model, path)
        load_simple_checkpoint(path, fresh)
        theirs = dict(fresh.named_parameters())
        mismatched = [n for n, p in model.named_parameters() if not torch.equal(p.detach(), theirs[n].detach())]
        checkpoints[name] = {"bytes": nbytes, "leaves": len(theirs), "mismatched": mismatched[:4]}
        if mismatched:
            failed.append(f"{name} checkpoint: {mismatched[:4]}")

    # the phase's launches: every step, sampler step and forward above
    runs = video_runs + image_only_runs + image_runs
    total = {k: sum(r["launches"][k] for r in runs) + sum(s["launches"][k] for s in samples.values())
             for k in KERNELS}
    want_total = expected_counts()
    if not rehearse:
        for (kernel, *_), count in latent_run_launches(zoo, steps, timesteps).items():
            want_total[kernel] += count
        # the samplers' norms (the steps record gradients of every weight)
        want_total["group_norm_fused"] = timesteps * (module_group_norms(unet2d) + module_group_norms(unet3d))
    if total != want_total:
        failed.append(f"phase launches {total} != {want_total}")
    summary_ms = lambda rs: {"warmup_ms": rs[0]["ms"], "step_ms": [r["ms"] for r in rs[1:]],  # noqa: E731
                             "mean_step_ms": float(np.mean([r["ms"] for r in rs[1:]])) if len(rs) > 1 else None,
                             "losses": [r["loss"] for r in rs]}
    emit({"phase": "latent", "zoo": {k: list(v) if isinstance(v, tuple) else v for k, v in zoo.items()},
          "context_dim": ctx_dim, "encoded": encoded, "encode_s": timings,
          "video_train": {"batch": [LATENT_VIDEO_BATCH, frames, video_lat, video_lat, 4], **summary_ms(video_runs),
                          "launches_per_step": per_video},
          "image_only_train": {"batch": [LATENT_VIDEO_BATCH, video_lat, video_lat, 4],
                               "step_ms": [r["ms"] for r in image_only_runs],
                               "losses": [r["loss"] for r in image_only_runs]},
          "image_train": {"batch": [LATENT_IMAGE_BATCH, image_lat, image_lat, 4], **summary_ms(image_runs),
                          "launches_per_step": per_image},
          "parameters": {"video": len(start3d), "image": len(start2d),
                         "video_numel": sum(p.numel() for p in start3d.values()),
                         "image_numel": sum(p.numel() for p in start2d.values())},
          "sampling": {"timesteps": timesteps, "guidance_scale": LATENT_GUIDANCE, **samples},
          "dome": {"batch": dome_batch, "forward_ms": dome_ms, "finite": bool(torch.isfinite(yd).all())},
          "checkpoints": checkpoints, "launches": total, "expected_launches": want_total,
          "peak_memory_gb": None if rehearse else torch.cuda.max_memory_allocated() / 1e9, "failed": failed})
    if failed:
        raise AssertionError(f"latent: {failed}")
    return total


# trace_unet's per-module sums against the profiler's own kernel total
TRACE_SUM_REL_MAX = 0.01


def _tool_records(tool, argv, model_cfg):
    """``tool.main(argv, model_cfg)`` with its standard output captured:
    (exit code, its JSON records, its closing line, seconds)."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(argv, model_config=model_cfg)
    lines = buf.getvalue().strip().splitlines()
    return rc, [json.loads(line) for line in lines[:-1]], lines[-1] if lines else None, time.perf_counter() - t0


def phase_profilers(model_cfg, dev, rehearse: bool) -> None:
    """The four profilers through their ``main`` at reduced iterations:
    ``ops.trace_unet`` (one 512 px 16-frame int8 evaluation; its per-module
    sums equal the profiler's own kernel total within
    ``TRACE_SUM_REL_MAX``), ``ops.profile_unet`` (every variant timed from a
    graph of 2 evaluations, its K1 / K2 / K4 launches per evaluation as the
    variant's config derives them, none in ``attention_sdpa``),
    ``ops.profile_motion`` (every level and variant timed, K2 / K6 launches
    as their routes give them; the decode at slices 2 and 16) and
    ``ops.tune`` (K1 and SDPA rows at every site in both layouts, K1 within
    its tolerance).  Each tool's closing line is the card's nvidia-smi
    line.  Their launches are not the main path's and are not counted."""
    from i2v_adapter_tpu_torch.ops import profile_motion, profile_unet, trace_unet, tune

    small = ["--device", "cpu", "--size", "32", "--frames", "2"] if rehearse else []
    lat = (32 if rehearse else 512) // model_cfg.vae.spatial_scale_factor
    card = None if rehearse else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    failed, line = [], {"phase": "profilers"}
    runs = {"trace_unet": (trace_unet, small + ["--evals", "1", "--top", "12"]),
            "profile_unet": (profile_unet, small + ["--evals", "2"]),
            "profile_motion": (profile_motion,
                               small + ["--iters", "4", "--decode-slices", "2" if rehearse else "2,16"]),
            "tune": (tune, (["--device", "cpu"] if rehearse else []) + ["--iters", "3"])}
    records = {}
    for name, (tool, argv) in runs.items():
        reset_launch_counts()
        rc, records[name], closing, seconds = _tool_records(tool, argv, model_cfg)
        line[f"{name}_s"] = seconds
        if rc != 0 or not records[name] or closing != (card or "cpu (plain math, no device times)"):
            failed.append(f"{name}: exit {rc}, {len(records[name])} records, closing line {closing!r}")
    reset_launch_counts()

    # trace_unet: the module split of the step's device time
    by = {r["result"]: r for r in records["trace_unet"]}
    summary = by.get("summary", {})
    line["trace_unet"] = {"summary": summary, "by_module_kind_ms": by.get("by_module_kind", {}).get("ms"),
                          "top_modules_ms": by.get("top_modules", {}).get("ms"),
                          "elementwise": {k: by.get("elementwise", {}).get(k)
                                          for k in ("total_ms", "by_module_kind_ms", "top_modules_ms")}}
    if not rehearse:
        total = summary.get("profiler_kernel_ms") or 0.0
        if not total or abs(summary.get("module_sum_ms", 0.0) - total) > TRACE_SUM_REL_MAX * total:
            failed.append(f"trace_unet: module sum {summary.get('module_sum_ms')} ms against the profiler's {total}")
        # the whole evaluation runs inside the UNet's own range
        if summary.get("outside_ms", 0.0) > TRACE_SUM_REL_MAX * total:
            failed.append(f"trace_unet: {summary.get('outside_ms')} ms charged to no module")

    # profile_unet: each variant's launches as its config derives them
    variants = {name: (ucfg, sdpa) for name, ucfg, sdpa in profile_unet.variants(model_cfg.unet)}
    line["profile_unet"] = {}
    for r in records["profile_unet"]:
        ucfg, sdpa = variants[r["variant"]]
        flash, temporal = (0, 0) if sdpa else launches_per_unet_eval(ucfg, lat, ucfg.use_i2v_adapter)
        want = expected_counts() if rehearse else expected_counts(
            flash_attention=flash, temporal_attention_cs=temporal,
            conv3x3_kernel=conv_launches_per_unet_eval(ucfg) if ucfg.conv_impl == "pallas" else 0,
            group_norm_fused=group_norms_per_unet_eval(ucfg))
        line["profile_unet"][r["variant"]] = {"per_eval_ms": r["per_eval_ms"], "launches_per_eval":
                                              r["launches_per_eval"], "expected": want}
        if r["launches_per_eval"] != want or not r["finite"] or (not rehearse and not r["per_eval_ms"]):
            failed.append(f"profile_unet {r['variant']}: {r}, want launches {want}")
    if len(records["profile_unet"]) != len(variants):
        failed.append(f"profile_unet: {len(records['profile_unet'])} records for {len(variants)} variants")

    # profile_motion: K2 where S >= 128 under 'auto', K6 at every S; the
    # GroupNorm kernel in the two variants with the motion module's norm
    line["profile_motion"] = []
    per_kernel = {"full_motion_module": 2, "temporal_attn_k2": 1, "temporal_attn_k6": 1}
    normed = ("full_motion_module", "groupnorm_only")
    for r in records["profile_motion"]:
        line["profile_motion"].append({k: r.get(k) for k in ("variant", "side", "channels", "decode_slice", "ms")})
        if r["variant"] == "vae_decode":
            ok = r["finite"]
        else:
            n = per_kernel.get(r["variant"], 0)
            if r["variant"] != "temporal_attn_k6" and r["tokens"] < 128:
                n = 0
            want = expected_counts() if rehearse else expected_counts(
                temporal_attention_cs=n, group_norm_fused=int(r["variant"] in normed and _group_norm_takes(
                    r["channels"], model_cfg.unet.norm_num_groups, torch.bfloat16)))
            ok = r["finite"] and r["launches_per_call"] == want
        if not ok or (not rehearse and not r["ms"]):
            failed.append(f"profile_motion: {r}")
    n_motion = 7 * len(profile_motion.sites(model_cfg, 32 if rehearse else 512)) + (1 if rehearse else 2)
    if len(records["profile_motion"]) != n_motion:
        failed.append(f"profile_motion: {len(records['profile_motion'])} records, want {n_motion}")

    # tune: K1 and SDPA at every site and layout
    line["tune"] = [{k: r.get(k) for k in ("site", "layout", "k1_ms", "k1_tflops", "sdpa_ms", "sdpa_tflops",
                                           "plain_ms", "bound_ms", "rel_err")} for r in records["tune"]]
    got = [(r["site"], r["layout"]) for r in records["tune"]]
    if got != [(site[0], layout) for site in tune.SITES for layout in tune.LAYOUTS]:
        failed.append(f"tune: rows {got}")
    for r in records["tune"]:
        if not (r["ok"] and r["k1_launched"]) or (not rehearse and not (r["k1_ms"] and r["sdpa_ms"])):
            failed.append(f"tune: {r}")
    line["failed"] = failed
    emit(line)
    if failed:
        raise AssertionError(f"profilers: {failed}")


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
    per_step = launches_per_train_step(model_cfg, latent, tcfg)
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
     "i2v_adapter_tpu/ops/attention.py:143",
     ("pipeline", "pipeline_pallas", "scan", "serve", "serve_heads", "cli", "driver", "driver_t2i", "train",
      "train_pallas", "latent", "mesh", "mesh_train"),
     "launches_per_eval"),
    ("temporal_attention_cs", "temporal_attention_cs", "temporal_attention_cs",
     CSRC + "temporal_attention.cu", "i2v_adapter_tpu/ops/attention.py:985",
     ("pipeline", "pipeline_pallas", "scan", "serve", "serve_heads", "cli", "driver", "train", "train_pallas",
      "mesh", "mesh_train"),
     "launches_per_eval"),
    ("flash_attention_bwd", "flash_attention_bwd", "flash_attention_bwd",
     CSRC + "flash_attention_bwd.cu", "i2v_adapter_tpu/ops/attention.py:518",
     ("driver", "driver_t2i", "train", "train_pallas", "latent", "mesh_train"), "launches_per_step"),
    ("conv3x3_kernel", "conv3x3_kernel", "conv3x3_kernel", CSRC + "conv3x3.cu",
     "i2v_adapter_tpu/ops/conv3x3.py:44", ("pipeline_pallas", "scan", "train_pallas"), "launches_per_eval"),
    ("flash_attention[transposed_io=False]", "flash_attention_row_major", "flash_attention",
     CSRC + "flash_attention.cu", "i2v_adapter_tpu/ops/attention.py:85", ("layouts",),
     "launches_per_eval"),
    ("temporal_attention[impl=kernel]", "temporal_attention_forced", "temporal_attention_cs",
     CSRC + "temporal_attention.cu", "i2v_adapter_tpu/ops/attention.py:871", ("unet_forced_temporal",),
     "launches_per_eval"),
    ("int8_matmul", "int8_matmul", "int8_matmul", CSRC + "int8_matmul.cu",
     "i2v_adapter_tpu/ops/profile_int8_dense.py:103",
     ("pipeline_int8", "scan", "serve", "serve_heads", "driver", "int8_tool", "mesh"), "launches_per_eval"),
    ("int8_conv3x3_kernel", "int8_conv3x3_kernel", "int8_conv3x3_kernel", CSRC + "int8_conv3x3.cu",
     "i2v_adapter_tpu/models/layers.py:148", ("pipeline_int8", "scan", "serve", "serve_heads", "driver", "mesh"),
     "launches_per_clip"),
    ("quantize_weights", "quantize_weights", "quantize_weights", CSRC + "int8_conv3x3.cu",
     "i2v_adapter_tpu/models/layers.py:159", ("pipeline_int8", "scan", "serve", "serve_heads", "driver"),
     "launches_per_load"),
)


def summary(rows, paths) -> dict:
    """Per kernel: launches on its main paths (each path counted from 0)
    and the launch-weighted mean per launch over its main-path shapes
    (weights: launches per serving UNet evaluation, per training step for
    K3, per evaluation for K7's downsample shapes, per 512 px clip for the
    int8 conv); where a kernel also runs elsewhere, the same means over
    those shapes: the training step's for K2, K3 and K4 (``train_ms``,
    weights: launches per step), the int8 tool's for K7 (``tool_ms``) and
    the driver's 256 px validation clip's for K7 and the int8 conv
    (``validation_ms``, weights: launches per validation clip).
    ``library_ms`` is null where no PyTorch call computes the function."""
    out = []
    for name, key, counter, source, replaces, on_paths, weight_key in SUMMARY:
        cases = rows[key]

        def means(weight_key, keys):
            main = [r for r in cases if r.get(weight_key, 0) > 0]
            w = sum(r[weight_key] for r in main)
            return {k: None if any(r.get(k) is None for r in main)
                    else sum(r[k] * r[weight_key] for r in main) / w for k in keys}, main, w

        m, main, w = means(weight_key, ("ms", "plain_ms", "bound_ms", "library_ms"))
        bytes_side = sum(r[weight_key] for r in main if r["bound_by"] == "bytes")
        by_path = {p: paths[p][counter] for p in on_paths}
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(v for r in cases for k, v in r.items() if k.startswith("abs_err")),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": "bytes" if bytes_side * 2 > w else "operations",
            "library_ms": m["library_ms"],
        })
        for prefix, other in (("train", "launches_per_step"), ("tool", "launches_per_tool_run"),
                              ("validation", "launches_per_validation_clip"),
                              ("latent", "launches_per_latent_run"), ("mesh", "launches_per_mesh_eval"),
                              ("mesh_train", "launches_per_mesh_train_step")):
            if other != weight_key and any(r.get(other, 0) > 0 for r in cases):
                extra = means(other, ("ms", "plain_ms", "bound_ms", "library_ms")
                              if prefix in ("latent", "mesh", "mesh_train") else ("ms", "bound_ms", "library_ms"))[0]
                out[-1].update({f"{prefix}_{k}": v for k, v in extra.items()})
        if any("dequant_ms" in r for r in main):
            out[-1].update({k: means(weight_key, (k,))[0][k] for k in ("dequant_ms", "dequant_bound_ms")})
        if any("cudnn_bf16_ms" in r for r in main):
            out[-1]["cudnn_bf16_ms"] = means(weight_key, ("cudnn_bf16_ms",))[0]["cudnn_bf16_ms"]
        if weight_key == "launches_per_load":  # the quantiser: once per load, none per clip
            out[-1].update(launches_per_clip=sum(r["launches_per_clip"] for r in main),
                           launches_per_load=sum(r["launches_per_load"] for r in main))
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at the tiny config with plain math (no card)")
    ap.add_argument("--only", choices=("mesh", "mesh_train"), default=None,
                    help="mesh: the device, build and mesh phases alone (with the pretrained directory "
                         "for the daemon on 4 cards), as a 4-card run takes them; mesh_train: the device, "
                         "build and mesh_train phases alone")
    args = ap.parse_args(argv)
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from i2v_adapter_tpu_torch.config import I2VModelConfig, tiny_test_config

    rehearse = args.rehearse
    dev = torch.device("cpu") if rehearse else torch.device("cuda", 0)
    dtype = torch.float32 if rehearse else torch.bfloat16
    model_cfg = I2VModelConfig()
    if rehearse:  # the tiny config, its image encoder giving a full_face head's 257 tokens (32 px / 2 px + 1)
        model_cfg = tiny_test_config()
        model_cfg = model_cfg.replace(image_encoder=model_cfg.image_encoder.replace(image_size=32, patch_size=2))

    info = phase_device(rehearse)
    phase_build(rehearse)
    if args.only == "mesh_train":
        phase_mesh_train(model_cfg, dev, rehearse)
        print(info["nvidia_smi"], flush=True)
        emit({"ok": True, "device": _device_record(rehearse)})
        return 0
    if args.only == "mesh":
        try:
            ckpt = phase_pretrained(model_cfg, dev, rehearse) if mesh_shapes(
                1 if rehearse else torch.cuda.device_count(), rehearse)[0] == (2, 1, 2) else {}
            phase_mesh(model_cfg, dev, rehearse, ckpt)
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        print(info["nvidia_smi"], flush=True)
        emit({"ok": True, "device": _device_record(rehearse)})
        return 0
    rows = phase_kernels(dev, rehearse)
    unet, fused_unet, forced_counts = phase_unet(model_cfg, dev, dtype, rehearse)
    layout_counts = phase_layouts(dev, rehearse)
    counts, fused_counts, int8_counts, pipe = phase_pipeline(model_cfg, unet, fused_unet, dev, dtype, rehearse)
    scan_counts = phase_scan(model_cfg, pipe, fused_unet, dev, rehearse)
    del unet, fused_unet, pipe
    ckpt = phase_pretrained(model_cfg, dev, rehearse)
    try:
        serve_counts = phase_serve(model_cfg, dev, rehearse, ckpt)
        heads_counts = phase_serve_heads(model_cfg, dev, rehearse, ckpt)
        cli_counts = phase_cli(model_cfg, dev, rehearse, ckpt)
        mesh_counts = phase_mesh(model_cfg, dev, rehearse, ckpt)
        mesh_train_counts = phase_mesh_train(model_cfg, dev, rehearse)
        driver_counts, driver_t2i_counts = phase_driver(model_cfg, dev, rehearse, ckpt)
        latent_counts = phase_latent(model_cfg, dev, rehearse, ckpt)
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    train_state, batch, step_fn, train_counts, first_loss = phase_train(model_cfg, dev, rehearse)
    phase_gradcheck(train_state, batch, step_fn, rehearse)
    del train_state, batch, step_fn
    fused_cfg = model_cfg.replace(unet=model_cfg.unet.replace(conv_impl="pallas"))
    fused_train_counts = phase_train(fused_cfg, dev, rehearse, steps=PALLAS_TRAIN_STEPS,
                                     phase="train_pallas", first_loss=first_loss)[3]
    tool_counts = phase_int8_tool(dev, rehearse)
    phase_profilers(model_cfg, dev, rehearse)
    if rows is not None:
        kernels = summary(rows, {
            "pipeline": counts, "pipeline_pallas": fused_counts, "pipeline_int8": int8_counts,
            "scan": scan_counts,
            "serve": serve_counts, "serve_heads": heads_counts, "cli": cli_counts, "mesh": mesh_counts,
            "mesh_train": mesh_train_counts, "driver": driver_counts,
            "driver_t2i": driver_t2i_counts, "latent": latent_counts, "train": train_counts,
            "train_pallas": fused_train_counts, "layouts": layout_counts,
            "unet_forced_temporal": forced_counts, "int8_tool": tool_counts})
        idle = [k["name"] for k in kernels["kernels"] if k["launches"] <= 0]
        if idle:
            raise AssertionError(f"kernels never launched on their main path: {idle}")
        emit(kernels)
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": _device_record(rehearse)})
    return 0


def _device_record(rehearse: bool) -> dict:
    if rehearse:
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}


if __name__ == "__main__":
    sys.exit(main())
