"""Offline image-folder -> latent encoder (the JAX package's
``tools/encode_image.py``).

VAE-encodes every image under a folder, resized and centre-cropped to
``--sample_size``, to one ``latents.npy`` (fp16, the posterior mean, not
scaled) plus a ``captions.txt`` of file stems.

Run: ``python -m i2v_adapter_tpu_torch.tools.encode_image --image_folder
DIR --vae_path <dir with the VAE's weights> --output_dir OUT`` (on the GPU;
``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np
import torch

logger = logging.getLogger(__name__)

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def load_vae(vae_path: str, config, device):
    """The VAE from the first ``*.safetensors`` (else ``*.bin``) file under
    ``vae_path``, through the port's key map, fp32 on ``device``."""
    from i2v_adapter_tpu_torch.models.vae import AutoencoderKL
    from i2v_adapter_tpu_torch.utils import convert

    weights = glob.glob(os.path.join(vae_path, "*.safetensors")) + glob.glob(os.path.join(vae_path, "*.bin"))
    vae = AutoencoderKL(config, device=device)
    convert.load_flax_params(vae, convert.convert_vae(convert.load_state_dict(weights[0]), config))
    return vae.eval()


@torch.no_grad()
def encode_frames(vae, frames: np.ndarray, device) -> np.ndarray:
    """(N, H, W, 3) in [-1, 1] -> the posterior means (N, h, w, c), fp32."""
    return vae.encode(torch.from_numpy(np.ascontiguousarray(frames, dtype=np.float32)).to(device)).cpu().numpy()


def encode_images(argv=None, model_config=None):
    """The command line.  ``model_config`` (an ``I2VModelConfig``; default
    SD1.5) is for callers that encode with another VAE shape from code."""
    p = argparse.ArgumentParser()
    p.add_argument("--image_folder", required=True)
    p.add_argument("--vae_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--sample_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    args = p.parse_args(argv)

    from PIL import Image

    from i2v_adapter_tpu_torch.config import VAEConfig
    from i2v_adapter_tpu_torch.device import resolve_device
    from i2v_adapter_tpu_torch.utils.image import resize_center_crop

    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    vae = load_vae(args.vae_path, model_config.vae if model_config is not None else VAEConfig(), dev)
    paths = sorted(p for p in glob.glob(os.path.join(args.image_folder, "**", "*"), recursive=True)
                   if p.lower().endswith(IMAGE_EXTS))
    os.makedirs(args.output_dir, exist_ok=True)
    latents, captions, batch = [], [], []
    for path in paths:
        try:
            img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
            img = resize_center_crop(img, args.sample_size, args.sample_size)
            batch.append(img * 2.0 - 1.0)
            captions.append(os.path.splitext(os.path.basename(path))[0])
        except Exception as e:  # noqa: BLE001 - one unreadable image is skipped
            logger.warning("skipping %s: %s", path, e)
        if len(batch) == args.batch_size:
            latents.append(encode_frames(vae, np.stack(batch), dev))
            batch = []
    if batch:
        latents.append(encode_frames(vae, np.stack(batch), dev))
    np.save(os.path.join(args.output_dir, "latents.npy"), np.concatenate(latents).astype(np.float16))
    with open(os.path.join(args.output_dir, "captions.txt"), "w") as f:
        f.write("\n".join(captions))
    logger.info("encoded %d images -> %s", len(captions), args.output_dir)


if __name__ == "__main__":
    encode_images()
