"""Inference CLI (the PyTorch port of the JAX package's
``pipelines/cli.py``): read an eval CSV of (prompt, image_path) rows, load
the pipeline with a task's epoch adapter checkpoint, and write one GIF per
row (GIF export needs ``imageio`` or PIL).

Run: ``python -m i2v_adapter_tpu_torch.pipelines.cli --task_name X
--checkpoint_epoch N --pretrained_model_path ... --eval_csv_path ...``
(on the GPU; ``--device cpu`` runs on the CPU).  ``--mesh data,tensor,seq``
runs each clip over several cards, one process per card (spawned here, or
started by ``torchrun``); rank 0 writes the GIFs.

``--model svd_xt`` serves Stable Video Diffusion img2vid-xt
(``StableVideoDiffusionPipeline``) instead: each CSV row's ``image_path``
(no prompt) becomes one GIF, with SVD-XT's request defaults (25 frames at
1024x576, 25 Euler steps, guidance 1.0 to 3.0, fps 7, motion bucket 127,
noise augmentation 0.02, decode chunks of 8 frames); ``--pretrained_model_path``
is a directory written by ``StableVideoDiffusionPipeline.save_pretrained``.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import sys

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="I2V-Adapter inference (PyTorch port)")
    p.add_argument("--task_name", type=str, required=True)
    p.add_argument("--checkpoint_epoch", type=int, default=None)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoint")
    p.add_argument("--pretrained_model_path", type=str, required=True)
    p.add_argument("--eval_csv_path", type=str, required=True, help="CSV with prompt,image_path columns")
    p.add_argument("--output_dir", type=str, default="samples")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--frame_similarity_sample_ratio", type=float, default=0.9)
    p.add_argument("--negative_prompt", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--mesh", type=str, default=None,
                   help="multi-card serving mesh 'data,tensor,seq': one process per card, spawned "
                        "here or started by torchrun")
    p.add_argument("--dispatch", type=str, default="auto", choices=("auto", "scan", "stepwise"),
                   help="'stepwise' runs one synchronised device pass per denoise step; 'scan' "
                        "replays each step kind from a CUDA graph; 'auto' picks by the clip's work")
    p.add_argument("--int8_conv", action=argparse.BooleanOptionalAction, default=True,
                   help="serving-mode int8 convs (UNet 3x3s + VAE decoder); --no-int8_conv "
                        "restores exact convs")
    p.add_argument("--encoder_cache", type=int, default=1, choices=(1, 2),
                   help="2 = opt-in: every second denoise step reuses the previous step's UNet "
                        "down-path features (encoder propagation, arXiv:2312.09608), a "
                        "content-level approximation; 1 (off) by default")
    p.add_argument("--cfg_cutoff", type=float, default=1.0,
                   help="opt-in adaptive guidance: the leading fraction of denoise steps that run "
                        "full CFG, the rest the conditional branch only; 1.0 (off) by default; "
                        "not composable with --encoder_cache 2")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def parse_svd_args(argv=None):
    """The options of ``--model svd_xt``; the defaults are
    ``SVDPipelineConfig``'s."""
    from i2v_adapter_tpu_torch.config import SVDPipelineConfig

    d = SVDPipelineConfig()
    p = argparse.ArgumentParser(description="Stable Video Diffusion img2vid-xt inference (PyTorch port)")
    p.add_argument("--model", choices=("svd_xt",), required=True)
    p.add_argument("--task_name", type=str, default="svd_xt")
    p.add_argument("--pretrained_model_path", type=str, required=True,
                   help="a directory written by StableVideoDiffusionPipeline.save_pretrained")
    p.add_argument("--eval_csv_path", type=str, required=True, help="CSV with an image_path column")
    p.add_argument("--output_dir", type=str, default="samples")
    for name in ("num_frames", "height", "width", "num_inference_steps", "fps", "motion_bucket_id",
                 "decode_chunk_size"):
        p.add_argument(f"--{name}", type=int, default=getattr(d, name))
    for name in ("min_guidance_scale", "max_guidance_scale", "noise_aug_strength"):
        p.add_argument(f"--{name}", type=float, default=getattr(d, name))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", type=str, default=d.dtype, choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default=None)
    return p.parse_args(argv)


def _svd_main(argv) -> list:
    from i2v_adapter_tpu_torch.config import SVDPipelineConfig
    from i2v_adapter_tpu_torch.pipelines.svd_pipeline import StableVideoDiffusionPipeline
    from i2v_adapter_tpu_torch.utils.image import export_to_gif, load_image

    args = parse_svd_args(argv)
    keys = ("num_frames", "height", "width", "num_inference_steps", "fps", "motion_bucket_id", "decode_chunk_size",
            "min_guidance_scale", "max_guidance_scale", "noise_aug_strength", "dtype")
    pc = SVDPipelineConfig(**{k: getattr(args, k) for k in keys})
    pipe = StableVideoDiffusionPipeline.from_pretrained(args.pretrained_model_path, pipeline_config=pc,
                                                        device=args.device)
    with open(args.eval_csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    os.makedirs(args.output_dir, exist_ok=True)
    written = []
    for i, row in enumerate(rows):
        video = pipe(load_image(row["image_path"]), seed=args.seed + i)
        path = export_to_gif(video[0], os.path.join(args.output_dir, f"{args.task_name}_{i}.gif"), fps=args.fps)
        logger.info("[%d/%d] %s", i + 1, len(rows), path)
        written.append(path)
    return written


def _cli_rank(argv, model_config, mesh_config) -> list:
    from i2v_adapter_tpu_torch.pipelines.serve import build_pipeline
    from i2v_adapter_tpu_torch.utils.image import load_image

    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    pipe, mesh = build_pipeline(args, model_config, mesh_config)
    leader = mesh is None or mesh.rank == 0
    with open(args.eval_csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    if leader:
        os.makedirs(args.output_dir, exist_ok=True)
    written = []
    for i, row in enumerate(rows):
        video = pipe(
            row["prompt"], condition_image=load_image(row["image_path"]),
            negative_prompt=args.negative_prompt, seed=args.seed + i, dispatch=args.dispatch,
            encoder_cache=args.encoder_cache, cfg_cutoff=args.cfg_cutoff,
        )
        if leader:
            out = pipe.export_gifs(video, os.path.join(args.output_dir, f"{args.task_name}_{i}"), fps=args.fps)
            logger.info("[%d/%d] %s", i + 1, len(rows), out[0])
            written.extend(out)
    return written


def main(argv=None, model_config=None) -> list:
    """Generate one GIF per CSV row; returns their paths.  ``model_config``
    (default: SD1.5, ``I2VModelConfig()``) is for callers that load another
    architecture from code; the command line loads SD1.5, or SVD-XT with
    ``--model svd_xt``."""
    from i2v_adapter_tpu_torch.parallel.launch import run_meshed
    from i2v_adapter_tpu_torch.parallel.mesh import parse_mesh

    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else list(argv)
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--model", choices=("i2v", "svd_xt"), default="i2v")
    chosen, rest = pre.parse_known_args(argv)
    if chosen.model == "svd_xt":
        return _svd_main(argv)
    argv = rest
    args = parse_args(argv)
    if args.mesh:
        config = parse_mesh(args.mesh)
        return run_meshed(_cli_rank, config, args.device, (argv, model_config, config))
    return _cli_rank(argv, model_config, None)


if __name__ == "__main__":
    main()
