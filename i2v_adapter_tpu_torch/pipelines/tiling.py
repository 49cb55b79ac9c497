"""Temporal tiling: clips longer than the motion modules' positional cap.

The port's copy of the JAX ``pipelines/tiling.py``: each denoise step
evaluates the UNet on overlapping temporal windows (the clip's first frame
is prepended to every window that does not start at frame 0, so the
cross-frame adapter still reads the condition frame), and the per-frame
noise predictions are averaged with linear cross-fade weights where the
windows overlap.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def temporal_windows(num_frames: int, window: int, stride: int) -> List[Tuple[int, int]]:
    """(start, end) windows covering ``[0, num_frames)``."""
    if num_frames <= window:
        return [(0, num_frames)]
    starts = list(range(0, num_frames - window + 1, stride))
    if starts[-1] + window < num_frames:
        starts.append(num_frames - window)
    return [(s, s + window) for s in starts]


def window_weights(window: int, overlap: int) -> np.ndarray:
    """Linear ramp-in / ramp-out weights for cross-fading window overlaps."""
    w = np.ones(window, np.float32)
    if overlap > 0:
        ramp = (np.arange(overlap) + 1) / (overlap + 1)
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return w


def window_weight_tensors(num_frames: int, window: int, stride: int, device, dtype) -> List[torch.Tensor]:
    """Per window of ``temporal_windows(num_frames, window, stride)``, its
    blend weights as a (1, frames, 1, 1, 1) tensor on ``device``: the ramps
    of ``window_weights``, no fade-in at the clip's start and none out at
    its end."""
    windows = temporal_windows(num_frames, window, stride)
    overlap = window - stride
    base_w = window_weights(window, overlap)
    out = []
    for wi, (s, e) in enumerate(windows):
        w = base_w.copy()
        if wi == 0:
            w[: max(overlap, 0)] = 1.0  # no fade-in at the clip start
        if wi == len(windows) - 1:
            tail = len(w) - max(overlap, 0)
            w[tail:] = np.maximum(w[tail:], base_w[tail:])
        out.append(torch.from_numpy(w).reshape(1, e - s, 1, 1, 1).to(device, dtype))
    return out


def tiled_unet_call(unet_apply, latents: torch.Tensor, window: int, stride: int, *,
                    caches=None, collect_caches: bool = False, weights=None):
    """Blend ``unet_apply(x, anchored)`` over the temporal windows of
    ``latents`` (B, F, H, W, C; a CFG-doubled batch is fine).  An anchored
    window carries the clip's first frame in front, whose prediction is
    dropped.

    Encoder-cache composition (one cache per window, each window being an
    independent UNet evaluation): ``collect_caches=True`` calls
    ``unet_apply(x, anchored, cache=None)`` for ``(pred, cache)`` and
    returns ``(blended, caches)``; ``caches=`` calls ``unet_apply(x,
    anchored, cache=caches[i])`` for window ``i``.  ``weights``: the
    windows' ``window_weight_tensors``, made once by a caller that replays
    the call from a CUDA graph (no host-to-device copy inside it)."""
    f = latents.shape[1]
    windows = temporal_windows(f, window, stride)
    if weights is None:
        weights = window_weight_tensors(f, window, stride, latents.device, latents.dtype)
    acc = torch.zeros_like(latents)
    norm = torch.zeros((1, f, 1, 1, 1), dtype=latents.dtype, device=latents.device)
    out_caches = []
    for wi, (s, e) in enumerate(windows):
        chunk = latents[:, s:e]
        anchored = s > 0
        x = torch.cat([latents[:, :1], chunk], dim=1) if anchored else chunk
        if collect_caches:
            pred, cache = unet_apply(x, anchored, cache=None)
            out_caches.append(cache)
        elif caches is not None:
            pred = unet_apply(x, anchored, cache=caches[wi])
        else:
            pred = unet_apply(x, anchored)
        if anchored:
            pred = pred[:, 1:]
        acc[:, s:e] += pred * weights[wi]
        norm[:, s:e] += weights[wi]
    blended = acc / norm
    if collect_caches:
        return blended, tuple(out_caches)
    return blended
