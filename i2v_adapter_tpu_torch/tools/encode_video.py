"""Offline video -> latent encoder (the JAX package's
``tools/encode_video.py``).

Walks a video folder, reads up to ``--max_frames_per_video`` frames of each
``*.mp4`` with OpenCV (``data/webvid.py``'s reader), resizes and
centre-crops them to ``--sample_size``, VAE-encodes them ``--slice_frames``
at a time (posterior means), and writes one flat ``latents.npy`` (fp16) +
``frames_per_video.npy`` + ``prompts.txt`` of file stems.  ``--shard`` /
``--num_shards`` split the folder across processes.

Run: ``python -m i2v_adapter_tpu_torch.tools.encode_video --video_folder
DIR --vae_path <dir with the VAE's weights> --output_dir OUT`` (on the GPU;
``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


def encode_videos(argv=None, model_config=None):
    """The command line.  ``model_config`` (an ``I2VModelConfig``; default
    SD1.5) is for callers that encode with another VAE shape from code."""
    p = argparse.ArgumentParser()
    p.add_argument("--video_folder", required=True)
    p.add_argument("--vae_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--sample_size", type=int, default=256)
    p.add_argument("--slice_frames", type=int, default=16)
    p.add_argument("--max_frames_per_video", type=int, default=64)
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--scaled", action="store_true", help="multiply latents by 0.18215 before saving")
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    args = p.parse_args(argv)

    from i2v_adapter_tpu_torch.config import VAEConfig
    from i2v_adapter_tpu_torch.data.webvid import _read_video_frames, video_length
    from i2v_adapter_tpu_torch.device import resolve_device
    from i2v_adapter_tpu_torch.tools.encode_image import encode_frames, load_vae
    from i2v_adapter_tpu_torch.utils.image import resize_center_crop

    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    cfg = model_config.vae if model_config is not None else VAEConfig()
    vae = load_vae(args.vae_path, cfg, dev)
    videos = sorted(glob.glob(os.path.join(args.video_folder, "**", "*.mp4"),
                              recursive=True))[args.shard:: args.num_shards]
    os.makedirs(args.output_dir, exist_ok=True)

    all_latents, frames_per_video, prompts = [], [], []
    for path in videos:
        try:
            n = min(video_length(path), args.max_frames_per_video)
            if n <= 0:
                raise IOError("empty video")
            frames = _read_video_frames(path, np.arange(n))
            frames = np.stack([resize_center_crop(f.astype(np.float32) / 255.0, args.sample_size,
                                                  args.sample_size) for f in frames]) * 2.0 - 1.0
            z = np.concatenate([encode_frames(vae, frames[i: i + args.slice_frames], dev)
                                for i in range(0, n, args.slice_frames)])
            if args.scaled:
                z = z * cfg.scaling_factor
            all_latents.append(z.astype(np.float16))
            frames_per_video.append(n)
            prompts.append(os.path.splitext(os.path.basename(path))[0])
        except Exception as e:  # noqa: BLE001 - one unreadable video is skipped
            logger.warning("skipping %s: %s", path, e)

    np.save(os.path.join(args.output_dir, "latents.npy"), np.concatenate(all_latents))
    np.save(os.path.join(args.output_dir, "frames_per_video.npy"), np.asarray(frames_per_video))
    with open(os.path.join(args.output_dir, "prompts.txt"), "w") as f:
        f.write("\n".join(prompts))
    logger.info("encoded %d videos (%d frames) -> %s", len(frames_per_video), sum(frames_per_video),
                args.output_dir)


if __name__ == "__main__":
    encode_videos()
