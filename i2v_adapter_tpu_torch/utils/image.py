"""Host-side image pre/post-processing (numpy / OpenCV / PIL).

The port's own copy of what the pipeline and its entry points use from the
JAX package's ``utils/image.py``: the VaeImageProcessor-style
condition-image preprocessing, CLIP normalisation, the uint8 video
postprocess, reading a condition image from a path, GIF / MP4 export and
the image grid.  GIF export needs ``imageio`` or PIL, MP4 export OpenCV,
the grid PIL.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def _to_numpy(image) -> np.ndarray:
    """PIL.Image or ndarray -> float32 HWC in [0, 1]."""
    if hasattr(image, "convert"):  # PIL
        image = np.asarray(image.convert("RGB"))
    image = np.asarray(image)
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    return image.astype(np.float32)


def _resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    try:
        import cv2

        return cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)
    except ImportError:  # pragma: no cover
        from PIL import Image

        pil = Image.fromarray((img * 255).astype(np.uint8))
        return np.asarray(pil.resize((width, height), Image.BILINEAR)).astype(np.float32) / 255.0


def resize_center_crop(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Aspect-preserving resize so the short side covers, then center crop."""
    h, w = img.shape[:2]
    scale = max(height / h, width / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    img = _resize_bilinear(img, nh, nw)
    top, left = (nh - height) // 2, (nw - width) // 2
    return img[top : top + height, left : left + width]


def preprocess_image(image, height: int, width: int) -> np.ndarray:
    """Condition image -> (H, W, 3) float32 in [-1, 1]."""
    return _resize_bilinear(_to_numpy(image), height, width) * 2.0 - 1.0


def preprocess_batch(images, height: int, width: int) -> np.ndarray:
    if not isinstance(images, (list, tuple)):
        images = [images]
    return np.stack([preprocess_image(im, height, width) for im in images])


def clip_preprocess(image, size: int = 224) -> np.ndarray:
    """Resize short side, center crop, CLIP mean/std -> (size, size, 3)."""
    img = resize_center_crop(_to_numpy(image), size, size)
    return (img - CLIP_MEAN) / CLIP_STD


def postprocess_video(video: np.ndarray) -> np.ndarray:
    """(B, F, H, W, 3) in [-1, 1] -> uint8."""
    video = np.clip(np.asarray(video, dtype=np.float32) / 2.0 + 0.5, 0.0, 1.0)
    return (video * 255.0).round().astype(np.uint8)


def load_image(path: str):
    """A condition image from a file, as a PIL image (the entry points'
    ``Image.open``)."""
    from PIL import Image

    return Image.open(path)


def export_to_gif(frames: Union[np.ndarray, Sequence[np.ndarray]], path: str, fps: int = 8) -> str:
    """Save (F, H, W, 3) uint8 frames as a GIF (imageio, else PIL)."""
    frames = [np.asarray(f) for f in frames]
    try:
        import imageio

        imageio.mimsave(path, frames, duration=1000 / fps, loop=0)
    except ImportError:
        from PIL import Image

        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
    return path


def export_to_mp4(frames: np.ndarray, path: str, fps: int = 8) -> str:
    """Save (F, H, W, 3) uint8 frames as an MP4 through OpenCV."""
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(cv2.cvtColor(np.asarray(f), cv2.COLOR_RGB2BGR))
    writer.release()
    return path


def save_image_grid(images: np.ndarray, path: str, ncols: int = 4) -> str:
    """(N, H, W, 3) uint8 -> one image of ``ncols`` columns, rows filled in
    order, empty cells black."""
    n, h, w, c = images.shape
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    grid = np.zeros((nrows * h, ncols * w, c), dtype=np.uint8)
    for i, img in enumerate(images):
        r, col = divmod(i, ncols)
        grid[r * h: (r + 1) * h, col * w: (col + 1) * w] = img
    from PIL import Image

    Image.fromarray(grid).save(path)
    return path
