"""Pre-encoded latent datasets (the JAX package's ``data/latent.py``).

Flat ``.npy`` latent arrays written by the offline encoders (``tools/``),
a ``frames_per_video.npy`` index and caption sidecars.  Raw VAE-unit
latents are clamped to +-2/0.18215 and divided by that bound, which
normalises them to [-1, 1], the range the latent trainers expect.  Numpy
only; ``random.Random(seed)`` draws in the JAX package's order, so equal
seeds give equal items.
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

LATENT_SCALE = 0.18215
STD_LATENT = 2.0 / LATENT_SCALE  # the clamp bound


class LatentImageDataset:
    def __init__(self, latent_path: str, caption_path: str):
        self.latents = np.load(latent_path, mmap_mode="r")
        with open(caption_path) as f:
            self.captions = [line.rstrip("\n") for line in f]
        if len(self.captions) < len(self.latents):
            raise ValueError(f"{len(self.latents)} latents vs {len(self.captions)} captions")

    def __len__(self):
        return len(self.latents)

    def __getitem__(self, idx: int) -> dict:
        z = np.asarray(self.latents[idx], dtype=np.float32)
        z = np.clip(z, -STD_LATENT, STD_LATENT) / STD_LATENT
        return {"latents": z, "text": self.captions[idx]}


class ImageFolderDataset:
    """Every image under ``root``, resized and centre-cropped to
    ``sample_size``, randomly flipped, in [-1, 1]; the caption is the
    containing folder's name."""

    IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")

    def __init__(self, root: str, sample_size: int = 256, flip: bool = True, seed: Optional[int] = None):
        import glob

        self.paths = sorted(p for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                            if p.lower().endswith(self.IMAGE_EXTS))
        if not self.paths:
            raise ValueError(f"no images under {root}")
        self.sample_size = sample_size
        self.flip = flip
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        from i2v_adapter_tpu_torch.utils.image import resize_center_crop

        path = self.paths[idx]
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        img = resize_center_crop(img, self.sample_size, self.sample_size)
        if self.flip and self.rng.random() < 0.5:
            img = img[:, ::-1]
        return {"pixel_values": np.ascontiguousarray(img * 2.0 - 1.0),
                "text": os.path.basename(os.path.dirname(path))}


class LatentVideoDataset:
    """A flat (sum of frames, h, w, c) latent array and its
    frames_per_video index.  Videos shorter than ``sample_n_frames`` are
    left out; each fetch takes a random window of ``sample_n_frames``
    consecutive frames."""

    def __init__(self, latent_path: str, frames_per_video_path: str, caption_path: Optional[str] = None,
                 sample_n_frames: int = 16, seed: Optional[int] = None):
        self.latents = np.load(latent_path, mmap_mode="r")
        frames_per_video = np.load(frames_per_video_path)
        offsets = np.concatenate([[0], np.cumsum(frames_per_video)])
        captions = None
        if caption_path is not None and os.path.exists(caption_path):
            with open(caption_path) as f:
                captions = [line.rstrip("\n") for line in f]
        self.sample_n_frames = sample_n_frames
        self.rng = random.Random(seed)
        self.videos = [(int(offsets[i]), int(n), captions[i] if captions else "")
                       for i, n in enumerate(frames_per_video) if n >= sample_n_frames]

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx: int) -> dict:
        start, n, caption = self.videos[idx]
        lo = self.rng.randint(0, n - self.sample_n_frames)
        z = np.asarray(self.latents[start + lo: start + lo + self.sample_n_frames], dtype=np.float32)
        return {"latents": z, "text": caption}
