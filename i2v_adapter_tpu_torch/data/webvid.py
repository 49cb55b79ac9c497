"""WebVid-layout video / caption dataset, decoded on the host.

The port's copy of the JAX package's ``data/webvid.py``: CSV rows
(``videoid``, ``name``, ``page_dir``) point at
``<video_folder>/<page_dir>/<videoid>.mp4``; a clip of ``sample_n_frames``
frames is sampled at ``sample_stride`` (its length clamped to the video's);
the CLIP image is the raw first frame, resized, center-cropped and
CLIP-normalised; the frames are randomly flipped left-right, resized,
center-cropped and scaled to [-1, 1]; image mode takes one random frame;
``shard`` / ``num_shards`` stripe the rows per process; a row that fails to
decode is replaced by a random one.

Decoding needs OpenCV (``cv2``): without it ``_read_video_frames`` and
``video_length`` raise ``ImportError``.  Preprocessing goes through the
native library (``data.native``) when it builds, else through numpy;
``WebVidDataset.preprocess`` records which.  All random draws (clip starts,
image-mode frames, flips, substitutes) come from one ``random.Random(seed)``
shared by the loader's threads, so their order follows the threads' with
more than one worker.
"""

from __future__ import annotations

import csv
import logging
import os
import random
from typing import Optional

import numpy as np

from i2v_adapter_tpu_torch.data import native
from i2v_adapter_tpu_torch.utils.image import CLIP_MEAN, CLIP_STD, resize_center_crop

logger = logging.getLogger(__name__)

# Decode through gaps up to this many frames; seek past larger ones (a seek
# rewinds to a keyframe and decodes forward, dearer than a few reads).
_SEEK_GAP = 32


def _read_video_frames(path: str, indices: np.ndarray) -> np.ndarray:
    """The frames at ``indices`` as (N, H, W, 3) uint8 RGB: seek to the
    first wanted frame and past every gap of more than ``_SEEK_GAP`` frames,
    read sequentially through smaller ones."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    try:
        want = sorted(set(int(i) for i in indices))
        decoded = {}
        pos = 0

        def seek(target: int) -> int:
            cap.set(cv2.CAP_PROP_POS_FRAMES, target)
            landed = int(cap.get(cv2.CAP_PROP_POS_FRAMES))
            # decoding forward from short of the target is exact; a backend
            # that reports landing past it is rewound to frame 0
            if landed > target:
                cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                landed = 0
            return landed

        if want[0] > _SEEK_GAP:
            pos = seek(want[0])
        for idx in want:
            if idx - pos > _SEEK_GAP:
                pos = seek(idx)
            while pos <= idx:
                ok, frame = cap.read()
                if not ok:
                    raise IOError(f"decode failed at frame {pos} of {path}")
                pos += 1
            decoded[idx] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        return np.stack([decoded[int(i)] for i in indices])
    finally:
        cap.release()


def video_length(path: str) -> int:
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


class WebVidDataset:
    def __init__(
        self,
        csv_path: str,
        video_folder: str,
        sample_size: int = 256,
        sample_stride: int = 4,
        sample_n_frames: int = 16,
        is_image: bool = False,
        clip_image_size: int = 224,
        shard: int = 0,
        num_shards: int = 1,
        seed: Optional[int] = None,
    ):
        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        self.rows = rows[shard::num_shards]
        logger.info("WebVid: %d rows (shard %d/%d)", len(self.rows), shard, num_shards)
        self.video_folder = video_folder
        self.sample_size = sample_size
        self.sample_stride = sample_stride
        self.sample_n_frames = sample_n_frames
        self.is_image = is_image
        self.clip_image_size = clip_image_size
        self.rng = random.Random(seed)
        self.preprocess = "native" if native.available() else "numpy"

    def __len__(self) -> int:
        return len(self.rows)

    def _get_clip(self, idx: int):
        row = self.rows[idx]
        path = os.path.join(self.video_folder, row["page_dir"], f"{row['videoid']}.mp4")
        n = video_length(path)
        if n <= 0:
            raise IOError(f"empty video {path}")
        if self.is_image:
            indices = np.array([self.rng.randint(0, n - 1)])
        else:
            clip_len = min(n, (self.sample_n_frames - 1) * self.sample_stride + 1)
            start = self.rng.randint(0, n - clip_len)
            indices = np.linspace(start, start + clip_len - 1, self.sample_n_frames).astype(int)
        return _read_video_frames(path, indices), row["name"]

    def __getitem__(self, idx: int) -> dict:
        while True:
            try:
                frames, caption = self._get_clip(idx)
                break
            except Exception as e:  # noqa: BLE001 - any decode fault resamples
                logger.warning("decode error on idx %d (%s); resampling", idx, e)
                idx = self.rng.randint(0, len(self.rows) - 1)

        size = self.sample_size
        if self.preprocess == "native":
            clip_image = native.preprocess_frames_clip(frames[:1], self.clip_image_size)[0]
            out = native.preprocess_frames_pm1(frames, size)
            if self.rng.random() < 0.5:
                out = native.hflip_frames(out)
            frames = out
        else:
            frames = frames.astype(np.float32) / 255.0
            # the CLIP image from the raw (unflipped) first frame
            clip_image = (resize_center_crop(frames[0], self.clip_image_size, self.clip_image_size)
                          - CLIP_MEAN) / CLIP_STD
            if self.rng.random() < 0.5:
                frames = frames[:, :, ::-1]
            frames = np.stack([resize_center_crop(f, size, size) for f in frames])
            frames = frames * 2.0 - 1.0

        if self.is_image:
            frames = frames[0]
        return {
            "pixel_values": np.ascontiguousarray(frames),
            "clip_image": clip_image.astype(np.float32),
            "text": caption,
        }
