"""GroupNorm statistics and apply as plain functions on tensors.

Counterpart of the JAX package's ``ops/norms.py`` functions: fp32
statistics per (sample, group) over every non-batch position of a
channel-last tensor, with the variance in the one-pass form
``E[x^2] - mean^2`` (what the reference computes on the fused-conv path;
``models.layers.group_norm`` uses the two-pass ``var_mean``).  The
reference's one-hot matmuls are a lowering of the same group sums and its
``GroupNormMM`` / ``LayerNormMM`` modules with their environment switches
are not carried over.

``fold_gn_affine`` folds GroupNorm's statistics and affine into per-(sample,
channel) vectors ``a, s`` with ``silu(h*a + s) == silu(GroupNorm(h))``,
which is what ``ops.conv3x3.gn_silu_conv3x3`` takes.
"""

from __future__ import annotations

import torch


def group_norm_stats_matmul(x: torch.Tensor, num_groups: int):
    """Per-(batch, group) mean and variance of ``x`` (B, ..., C), fp32
    ``(B, num_groups)`` each.  Both sums reduce in fp32 straight from x's
    dtype (no fp32 copy of x is written)."""
    b, c = x.shape[0], x.shape[-1]
    x3 = x.reshape(b, -1, c)
    per_group = c // num_groups
    n = x3.shape[1] * per_group
    tok_sum = x3.sum(1, dtype=torch.float32)  # (B, C)
    tok_sq = torch.linalg.vector_norm(x3, dim=1, dtype=torch.float32).square()  # (B, C)
    mean = tok_sum.view(b, num_groups, per_group).sum(-1) / n
    sq = tok_sq.view(b, num_groups, per_group).sum(-1) / n
    return mean, sq - mean * mean


def group_norm_apply(x, mean, var, scale, bias, num_groups: int, eps: float) -> torch.Tensor:
    """Normalise with per-(batch, group) statistics; result in x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    reps = c // num_groups
    rstd = (var + eps) ** -0.5
    shape = (b,) + (1,) * (x.ndim - 2) + (c,)
    mean_c = mean.repeat_interleave(reps, dim=-1).reshape(shape)
    rstd_c = rstd.repeat_interleave(reps, dim=-1).reshape(shape)
    y = (x.float() - mean_c) * rstd_c
    return (y * scale.float() + bias.float()).to(x.dtype)


def fold_gn_affine(h: torch.Tensor, groups: int, eps: float, gamma, beta):
    """``(a, s)``, fp32 ``(B, C)`` each, with ``silu(h*a + s) ==
    silu(GroupNorm(h))``."""
    mean, var = group_norm_stats_matmul(h, groups)
    rstd = (var + eps) ** -0.5
    reps = h.shape[-1] // groups
    a = rstd.repeat_interleave(reps, dim=-1) * gamma.float()[None]
    s = beta.float()[None] - mean.repeat_interleave(reps, dim=-1) * a
    return a, s
