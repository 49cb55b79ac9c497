"""The collectives of one meshed denoise step, counted and timed (the JAX
package's ``tools/audit_multichip.py --case infer``).

The JAX tool compiles the sharded step and parses its HLO; the port's
collectives are its own calls, so this runs one denoise step of the serving
default (int8 convs, CFG 7.5, a condition image) on every rank of the mesh
with ``parallel.collectives.recording`` on, after one warm-up step, and
prints rank 0's record in the JAX audit's JSON shape (``by_kind`` with
count, output bytes and the ring model's wire bytes per device;
``total_ops``; ``top_ops``), with each kind's ms on the cards (each
collective issued again alone and timed, ``parallel.audit.time_collectives``),
the counts ``parallel.audit.collectives_per_unet_eval`` derives from the
config beside them, one decode's collectives, and each rank's peak memory.

    python -m i2v_adapter_tpu_torch.tools.audit_multichip --mesh 2,1,2
    python -m i2v_adapter_tpu_torch.tools.audit_multichip --mesh 2,1,2 --device cpu --tiny

(the first on data x tensor x seq cards, SD1.5 at 512 px and 16 frames,
seeded random weights; the second on gloo ranks at the tiny config).
``--case train`` waits for training over a mesh.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="collective audit of one meshed denoise step")
    p.add_argument("--case", choices=("infer", "train"), default="infer")
    p.add_argument("--mesh", type=str, default="2,1,2", help="data,tensor,seq")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--tiny", action="store_true", help="the tiny test config (CPU runs)")
    p.add_argument("--device", type=str, default=None, help="'cpu' runs gloo ranks on the CPU")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None, help="also write the JSON here")
    return p.parse_args(argv)


def audit_step(pipe, size: int, frames: int, seed: int = 0) -> dict:
    """One recorded CFG denoise step (after an unrecorded one) and one
    recorded decode of ``pipe`` (meshed or not) at ``size`` px and
    ``frames`` frames: the summaries, the top calls and the expected
    counts."""
    import numpy as np
    import torch

    from i2v_adapter_tpu_torch.parallel import audit, collectives

    cfg = pipe.config
    lat = size // cfg.vae.spatial_scale_factor
    parts = pipe._build_parts(1, frames, size, size, 25, 0.9, 7.5, True, True)
    prep, step, decode, ts, prev = parts[:5]
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    image = np.random.default_rng(seed).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    isz = cfg.image_encoder.image_size
    clip = np.random.default_rng(seed + 1).standard_normal((1, isz, isz, 3)).astype(np.float32)
    with torch.inference_mode():
        latents, consts = prep(pipe.tokenizer(["", "a cat"]), image, clip, gen)
        latents = step(consts, latents, ts[0], prev[0])  # warm-up: plans, communicators
        with collectives.recording() as step_ops:
            latents = step(consts, latents, ts[1], prev[1])
        with collectives.recording() as decode_ops:
            decode(consts, latents)
    if pipe.device.type == "cuda":
        pipe._sync()
        audit.time_collectives(step_ops, pipe.device)
        audit.time_collectives(decode_ops, pipe.device)
    shape = pipe.mesh.shape if pipe.mesh is not None else {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1}
    int8 = cfg.unet.int8_conv
    return {
        "summary": audit.summarize(step_ops),
        "expected": audit.collectives_per_unet_eval(cfg.unet, shape, 2, frames, lat, True, int8),
        "top_ops": audit.top_ops(step_ops),
        "decode": audit.summarize(decode_ops),
        "decode_expected": audit.collectives_per_decode(cfg.vae, shape, frames, cfg.vae.int8_decode),
    }


def _audit_rank(args, mesh_config) -> dict:
    import torch

    from i2v_adapter_tpu_torch.config import I2VModelConfig, PipelineConfig, tiny_test_config
    from i2v_adapter_tpu_torch.parallel.mesh import create_mesh
    from i2v_adapter_tpu_torch.utils.random_init import random_pipeline

    mesh = create_mesh(mesh_config, device=args.device)
    model_cfg = tiny_test_config() if args.tiny else I2VModelConfig()
    dtype = "float32" if mesh.device.type == "cpu" else "bfloat16"
    pipe = random_pipeline(model_cfg, PipelineConfig(num_frames=args.frames, height=args.size, width=args.size,
                                                     dtype=dtype), mesh.device, seed=args.seed + 1)
    pipe.enable_mesh(mesh)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    record = audit_step(pipe, args.size, args.frames, args.seed)
    record["seconds"] = time.perf_counter() - t0
    record["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device) if cuda else None
    return record


def main(argv=None) -> dict:
    from i2v_adapter_tpu_torch.parallel.launch import run_ranks
    from i2v_adapter_tpu_torch.parallel.mesh import parse_mesh

    args = parse_args(argv)
    if args.case == "train":
        raise NotImplementedError("--case train: training over a mesh is not ported yet (ROADMAP: PR 14)")
    config = parse_mesh(args.mesh)
    n = config.data * config.tensor * config.seq
    ranks = run_ranks(_audit_rank, n, (args, config), args.device)
    rec = ranks[0]
    wire = rec["summary"]["wire_bytes_per_device"]
    out = {
        "devices": n, "tiny": args.tiny, "platform": "cpu" if args.device == "cpu" else "gpu",
        "cases": {"infer": {
            "meta": {"mesh": {"data": config.data, "fsdp": 1, "tensor": config.tensor, "seq": config.seq},
                     "workload": f"{args.size}px {args.frames}f batch1 CFG step, the serving default"},
            "summary": rec["summary"],
            "expected_counts": rec["expected"],
            "counts_match": {k: v["count"] for k, v in rec["summary"]["by_kind"].items()} == rec["expected"],
            "wire_gb_per_device": wire / 1e9,
            "decode": rec["decode"], "decode_expected_counts": rec["decode_expected"],
            "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
            "top_ops": rec["top_ops"],
        }},
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
