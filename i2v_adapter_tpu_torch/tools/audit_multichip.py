"""The collectives of one meshed denoise step or train step, counted and
timed (the JAX package's ``tools/audit_multichip.py``).

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

A train case (``--case train_dp`` ... ``train_motion_512``, ``TRAIN_CASES``:
the JAX audit's train meshes that fit four cards) audits one train step of
config 4 (256 px, 16 frames, 2 clips per ``data`` x ``fsdp`` way, bf16,
activation checkpointing, AdamW; the 512 px motion finetune at 1 clip a
way with the motion modules trained), the state placed over the case's
mesh (``--mesh data,fsdp,tensor,seq`` puts it on another): one recorded
step after a warm-up one, its collectives forward, recompute and
backward, ZeRO's gathers and reduce-scatters and the sums, each timed
alone on the cards and held to
``parallel.audit.collectives_per_train_step``; each rank's peak memory and
the step's ms.

    --case train_dp                 (4,1,1,1)
    --case train_dp_fsdp            (2,2,1,1)
    --case train_dp_fsdp_frozrep    (2,2,1,1), fsdp_frozen='replicate'
    --case train_dp_seq             (2,1,1,2)
    --case train_tp                 (2,1,2,1)
    --case train_motion_512         (1,2,1,2), 512 px, 1 clip a way, motion
"""

from __future__ import annotations

import argparse
import json
import sys
import time


# the train cases: (data, fsdp, tensor, seq), fsdp_frozen, px, clips per
# data x fsdp way, motion modules trained
TRAIN_CASES = {
    "train_dp": ((4, 1, 1, 1), "shard", 256, 2, False),
    "train_dp_fsdp": ((2, 2, 1, 1), "shard", 256, 2, False),
    "train_dp_fsdp_frozrep": ((2, 2, 1, 1), "replicate", 256, 2, False),
    "train_dp_seq": ((2, 1, 1, 2), "shard", 256, 2, False),
    "train_tp": ((2, 1, 2, 1), "shard", 256, 2, False),
    "train_motion_512": ((1, 2, 1, 2), "shard", 512, 1, True),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="collective audit of one meshed denoise step or train step")
    p.add_argument("--case", choices=("infer",) + tuple(TRAIN_CASES), default="infer")
    p.add_argument("--mesh", type=str, default=None,
                   help="infer: data,tensor,seq (default 2,1,2); a train case: data,fsdp,tensor,seq "
                        "(default the case's)")
    p.add_argument("--size", type=int, default=None, help="default 512 (infer), the case's (train)")
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


def train_configs(case: str, mesh_config, tiny: bool, size=None, frames: int = 16):
    """A train case's model and train configs over ``mesh_config`` (config
    4; the tiny config at 32 px and 4 frames in fp32 for CPU runs)."""
    from i2v_adapter_tpu_torch.config import I2VModelConfig, reference_train_config, tiny_test_config

    _, frozen, px, clips, motion = TRAIN_CASES[case]
    tc = reference_train_config().replace(train_batch_size=clips * mesh_config.data * mesh_config.fsdp,
                                          mesh=mesh_config, update_motion_modules=motion, fsdp_frozen=frozen,
                                          uncond_prob_t=0.1, uncond_prob_i=0.1)
    if tiny:
        return tiny_test_config(), tc.replace(resolution=32, num_frames=4, mixed_precision="none",
                                              freeze_dtype="float32")
    return I2VModelConfig(), tc.replace(resolution=size or px, num_frames=frames)


def audit_train_step(state, step_fn, batch: dict, mesh, model_cfg, tc, warm_up: bool = True) -> dict:
    """One recorded train step of ``step_fn`` on this rank's ``batch``
    (after an unrecorded one with ``warm_up``): its collectives' summary,
    the top calls, the formula's counts and the recorded step's ms."""
    import torch

    from i2v_adapter_tpu_torch.parallel import audit, collectives

    dev = mesh.device
    cuda = dev.type == "cuda"
    if warm_up:
        state, _ = step_fn(state, batch)  # plans, communicators
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with collectives.recording() as ops:
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    if cuda:
        audit.time_collectives(ops, dev)
    lat = tc.resolution // model_cfg.vae.spatial_scale_factor
    expected = audit.collectives_per_train_step(model_cfg.unet, mesh.shape, tc, tc.train_batch_size, tc.num_frames,
                                                lat, state.zero.counts(state))
    return {"summary": audit.summarize(ops), "expected": expected, "top_ops": audit.top_ops(ops),
            "step_ms": step_ms, "loss": loss}


def _audit_train_rank(args, mesh_config, min_size: int) -> dict:
    import torch

    from i2v_adapter_tpu_torch.parallel.mesh import create_mesh, local_batch, train_state_shardings
    from i2v_adapter_tpu_torch.training import make_train_step
    from i2v_adapter_tpu_torch.training.checkpoint import train_state_tensors
    from i2v_adapter_tpu_torch.utils.random_init import random_train_batch, random_train_state

    mesh = create_mesh(mesh_config, device=args.device)
    model_cfg, tc = train_configs(args.case, mesh_config, args.tiny, args.size, args.frames)
    cuda = mesh.device.type == "cuda"
    specs = None
    if min_size != 2**16:  # the state's specs at another fsdp threshold
        whole = random_train_state(model_cfg, tc, mesh.device, seed=args.seed + 1)
        specs = train_state_shardings(whole, mesh, min_size, tc.fsdp_frozen == "replicate")
        del whole
    state = random_train_state(model_cfg, tc, mesh.device, seed=args.seed + 1, mesh=mesh, shardings=specs)
    batch = local_batch(random_train_batch(model_cfg, tc, mesh.device, seed=args.seed), mesh)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(mesh.device)
    record = audit_train_step(state, make_train_step(model_cfg, tc, mesh=mesh), batch, mesh, model_cfg, tc)
    record["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device) if cuda else None
    record["state_bytes"] = int(sum(t.numel() * t.element_size() for t in train_state_tensors(state).values()))
    return record


def parse_train_mesh(text: str):
    """``data,fsdp,tensor,seq`` (four positive integers) -> MeshConfig."""
    from i2v_adapter_tpu_torch.config import MeshConfig

    parts = text.split(",")
    try:
        sizes = [int(p) for p in parts]
    except ValueError:
        sizes = []
    if len(sizes) != 4 or min(sizes) < 1:
        raise ValueError(f"a train case's --mesh takes 'data,fsdp,tensor,seq', four positive integers; got {text!r}")
    return MeshConfig(*sizes)


def main_train(args, min_size: int = 2**16) -> dict:
    from i2v_adapter_tpu_torch.config import MeshConfig
    from i2v_adapter_tpu_torch.parallel.launch import run_ranks

    config = parse_train_mesh(args.mesh) if args.mesh else MeshConfig(*TRAIN_CASES[args.case][0])
    n = config.data * config.fsdp * config.tensor * config.seq
    ranks = run_ranks(_audit_train_rank, n, (args, config, min_size), args.device)
    rec = ranks[0]
    model_cfg, tc = train_configs(args.case, config, args.tiny, args.size, args.frames)
    return {
        "devices": n, "tiny": args.tiny, "platform": "cpu" if args.device == "cpu" else "gpu",
        "cases": {args.case: {
            "meta": {"mesh": config.to_dict(), "fsdp_frozen": tc.fsdp_frozen, "min_size": min_size,
                     "workload": f"{tc.resolution}px {tc.num_frames}f global batch {tc.train_batch_size} train "
                                 f"step ({'adapter + motion' if tc.update_motion_modules else 'adapter'}), "
                                 f"{tc.mixed_precision}, remat, AdamW"},
            "summary": rec["summary"],
            "expected_counts": rec["expected"],
            "counts_match": {k: v["count"] for k, v in rec["summary"]["by_kind"].items()} == rec["expected"],
            "wire_gb_per_device": rec["summary"]["wire_bytes_per_device"] / 1e9,
            "step_ms_per_rank": [r["step_ms"] for r in ranks],
            "loss": rec["loss"],
            "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
            "state_bytes_per_rank": [r["state_bytes"] for r in ranks],
            "top_ops": rec["top_ops"],
        }},
    }


def main(argv=None, min_size: int = 2**16) -> dict:
    """The audit of ``argv``'s case; ``min_size`` (from code) lowers a train
    case's fsdp sharding threshold, as a tiny state needs to shard."""
    from i2v_adapter_tpu_torch.parallel.launch import run_ranks
    from i2v_adapter_tpu_torch.parallel.mesh import parse_mesh

    args = parse_args(argv)
    if args.case in TRAIN_CASES:
        out = main_train(args, min_size)
        text = json.dumps(out, indent=1)
        print(text)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        return out
    args.mesh, args.size = args.mesh or "2,1,2", args.size or 512
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
