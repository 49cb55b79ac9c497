"""FreeU: frequency-domain re-weighting of the UNet's skip connections.

The port's copy of the JAX ``ops/freeu.py``: on the two coarsest up-block
stages the first half of the backbone channels is scaled by ``b`` and the
skip tensor's low spatial frequencies by ``s``.  The FFT is plain
``torch.fft`` math in fp32, as it was XLA's in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FreeUParams(NamedTuple):
    """SD1.5-recommended defaults."""

    s1: float = 0.9
    s2: float = 0.2
    b1: float = 1.2
    b2: float = 1.4


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the low-frequency box (|offset| < threshold around DC) of a
    channel-last ``(B, H, W, C)`` tensor."""
    freq = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(1, 2)), dim=(1, 2))
    _, h, w, _ = x.shape
    rows = torch.arange(h, device=x.device)[None, :, None, None]
    cols = torch.arange(w, device=x.device)[None, None, :, None]
    low = ((rows - h // 2).abs() < threshold) & ((cols - w // 2).abs() < threshold)
    low = low.float()
    freq = freq * (low * scale + (1.0 - low))
    out = torch.fft.ifftn(torch.fft.ifftshift(freq, dim=(1, 2)), dim=(1, 2)).real
    return out.to(x.dtype)


def apply_freeu(stage: int, hidden: torch.Tensor, skip: torch.Tensor, params: FreeUParams):
    """``(hidden, skip)`` re-weighted for up-block ``stage``; only stages 0
    and 1 change.  The backbone factor is rounded to the activation's dtype
    first, as a Python scalar is in JAX."""
    if stage == 0:
        b, s = params.b1, params.s1
    elif stage == 1:
        b, s = params.b2, params.s2
    else:
        return hidden, skip
    half = hidden.shape[-1] // 2
    factor = float(torch.tensor(b, dtype=hidden.dtype))  # on the host: no device copy
    hidden = torch.cat([hidden[..., :half] * factor, hidden[..., half:]], dim=-1)
    return hidden, fourier_filter(skip, threshold=1, scale=s)
