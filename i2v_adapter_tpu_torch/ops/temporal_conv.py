"""The (3, 1, 1) convolution over frames of channel-last clips.

``temporal_conv3(x, weight, bias)`` is ``nn.Conv3d(kernel_size=(3, 1, 1),
padding=(1, 0, 0))`` on ``x (B, F, S, C)`` (a clip's frames of S positions,
channels last) with its ``(O, I, 3, 1, 1)`` weight: frame f of the output
is ``b + W0 x[f-1] + W1 x[f] + W2 x[f+1]``, the frames outside the clip
zero.  It runs as one matmul over every frame (the centre tap, bias
included) and, per clip, one accumulating matmul per side tap over the
shifted frame views, in place: no im2col copy and no permute of the
activation around a library convolution (``F.conv3d`` would want the
channels-first layout, a copy in and one out).  In bf16 each accumulation
rounds the sum to bf16, as a bf16 conv's output is rounded once.

``temporal_conv3.launches`` counts its calls on the card (one call is the
``1 + 2 B`` library matmuls), none on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def temporal_conv3(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """``(B, F, S, C) -> (B, F, S, O)``; ``weight (O, C, 3, 1, 1)`` (cast to
    x's dtype), ``bias (O,)`` or None."""
    b, f, s, c = x.shape
    if weight.shape[1:] != (c, 3, 1, 1):
        raise ValueError(f"temporal_conv3: weight {tuple(weight.shape)} for {c} channels")
    w = weight.to(x.dtype)[..., 0, 0]  # (O, C, 3)
    x = x.contiguous()
    y = F.linear(x, w[..., 1], None if bias is None else bias.to(x.dtype))
    if f > 1:
        before, after = w[..., 0].t(), w[..., 2].t()
        for i in range(b):
            xi, yi = x[i].view(f * s, c), y[i].view(f * s, -1)
            yi[s:].addmm_(xi[:-s], before)  # frame f reads f - 1
            yi[:-s].addmm_(xi[s:], after)  # frame f reads f + 1
    if x.is_cuda:
        temporal_conv3.launches += 1
    return y


temporal_conv3.launches = 0


def temporal_conv3_plain(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """The same function through ``F.conv3d`` on the channels-first
    permute, in fp32; the result in x's dtype."""
    y = F.conv3d(x.float().permute(0, 3, 1, 2)[..., None], weight.float(),
                 None if bias is None else bias.float(), padding=(1, 0, 0))
    return y[..., 0].permute(0, 2, 3, 1).to(x.dtype)
