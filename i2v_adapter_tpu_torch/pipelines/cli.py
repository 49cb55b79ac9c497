"""Inference CLI (the PyTorch port of the JAX package's
``pipelines/cli.py``): read an eval CSV of (prompt, image_path) rows, load
the pipeline with a task's epoch adapter checkpoint, and write one GIF per
row (GIF export needs ``imageio`` or PIL).

Run: ``python -m i2v_adapter_tpu_torch.pipelines.cli --task_name X
--checkpoint_epoch N --pretrained_model_path ... --eval_csv_path ...``
(on the GPU; ``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import csv
import logging
import os

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
                   help="multi-device serving mesh 'data,tensor,seq': not ported yet, refused")
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


def main(argv=None, model_config=None) -> list:
    """Generate one GIF per CSV row; returns their paths.  ``model_config``
    (default: SD1.5, ``I2VModelConfig()``) is for callers that load another
    architecture from code; the command line always loads SD1.5."""
    from i2v_adapter_tpu_torch.config import PipelineConfig
    from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import I2VAdapterPipeline
    from i2v_adapter_tpu_torch.pipelines.serve import adapter_checkpoint, refuse_mesh
    from i2v_adapter_tpu_torch.utils.image import load_image

    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    refuse_mesh(args.mesh)
    adapter_path = adapter_checkpoint(args.checkpoint_dir, args.task_name, args.checkpoint_epoch)
    if adapter_path:
        logger.info("using adapter checkpoint %s", adapter_path)
    else:
        logger.warning("no adapter checkpoint found; zero-init adapter")
    pc = PipelineConfig(
        num_frames=args.num_frames, height=args.height, width=args.width,
        num_inference_steps=args.num_inference_steps, guidance_scale=args.guidance_scale,
        frame_similarity_sample_ratio=args.frame_similarity_sample_ratio,
        dtype=args.dtype, int8_conv=args.int8_conv,
    )
    pipe = I2VAdapterPipeline.from_pretrained(
        args.pretrained_model_path, model_config=model_config, pipeline_config=pc,
        i2v_adapter_path=adapter_path, device=args.device,
    )
    with open(args.eval_csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    os.makedirs(args.output_dir, exist_ok=True)
    written = []
    for i, row in enumerate(rows):
        video = pipe(
            row["prompt"], condition_image=load_image(row["image_path"]),
            negative_prompt=args.negative_prompt, seed=args.seed + i, dispatch=args.dispatch,
            encoder_cache=args.encoder_cache, cfg_cutoff=args.cfg_cutoff,
        )
        out = pipe.export_gifs(video, os.path.join(args.output_dir, f"{args.task_name}_{i}"), fps=args.fps)
        logger.info("[%d/%d] %s", i + 1, len(rows), out[0])
        written.extend(out)
    return written


if __name__ == "__main__":
    main()
