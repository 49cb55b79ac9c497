"""GroupNorm of channel-last tensors: the plain composition, the
hand-written kernel that replaces it where no gradient is recorded, and the
statistics and apply as plain functions.

``group_norm_plain`` is the models' GroupNorm in plain PyTorch: fp32
statistics per (sample, group) over every non-batch position with the
two-pass ``var_mean``, the affine in fp32, the result in x's dtype (and
``F.silu`` of it on request).  ``group_norm_fused`` computes the same
function with ``csrc/group_norm.cu`` on the card -- one statistics launch
and one apply launch, 6 bytes moved per bf16 element where the composition
moves about 48 -- and can fold in the SiLU and return the output's abs-max,
which is what ``ops.int8.int8_conv`` quantises by.  ``fused_group_norm_applies``
is the rule ``models.layers.group_norm`` dispatches by: the kernel on a CUDA
tensor it takes (bf16 or fp32, whole 16-byte vectors of channels; a strided
or unaligned x is copied first) when autograd records nothing; the
composition everywhere else (the CPU, the training graph).

Counterpart of the JAX package's ``ops/norms.py`` functions:
``group_norm_stats_matmul`` computes the variance in the one-pass form
``E[x^2] - mean^2`` (what the reference computes on the fused-conv path).
The reference's one-hot matmuls are a lowering of the same group sums and
its ``GroupNormMM`` / ``LayerNormMM`` modules with their environment
switches are not carried over.

``fold_gn_affine`` folds GroupNorm's statistics and affine into per-(sample,
channel) vectors ``a, s`` with ``silu(h*a + s) == silu(GroupNorm(h))``,
which is what ``ops.conv3x3.gn_silu_conv3x3`` takes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from i2v_adapter_tpu_torch.ops import _build


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


# ---------------------------------------------------------------------------
# GroupNorm: the composition and the kernel
# ---------------------------------------------------------------------------


def group_norm_plain(x, num_groups: int, eps: float, weight, bias, silu: bool = False) -> torch.Tensor:
    """GroupNorm of a channel-last tensor ``(N, ..., C)``: statistics per
    sample and group over every non-batch position, in fp32; then
    ``F.silu`` of the result when ``silu``."""
    shape = x.shape
    c = shape[-1]
    xf = x.reshape(shape[0], -1, num_groups, c // num_groups).float()
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, unbiased=False)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(shape)
    y = (y * weight.float() + bias.float()).to(x.dtype)
    return F.silu(y) if silu else y


_GN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GN_THREADS = 512        # csrc/group_norm.cu: MAX_THREADS
_GN_MAX_GROUPS = 1024    # MAX_GROUPS
_GN_UNROLL = 4           # STATS_UNROLL: rows a thread reads at once
_GN_MAX_CHUNKS = 128     # partials an apply CTA merges per group
_GN_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_GN_SLOTS: Dict[tuple, int] = {}  # (device, dtype, R, V) -> CTAs the card holds at once


def group_norm_rows(c: int, itemsize: int, rows: int) -> Tuple[int, int]:
    """``(R, V)``: a CTA of R x V threads reads R rows of V 16-byte vectors
    at a time, R x V <= 512."""
    v = c // (16 // itemsize)
    return max(1, min(_GN_THREADS // v, rows)), v


def group_norm_layout(n: int, rows: int, r: int, slots: int) -> Tuple[int, int]:
    """``(K, rows_per_chunk)`` of the kernel's (K, n) grid for ``n`` samples
    of ``rows`` positions read R at a time: at most one wave of the
    ``slots`` CTAs the card holds at once (a last, part-filled wave would
    cost a whole CTA's time), each thread reading ``_GN_UNROLL`` rows or
    more, each apply CTA merging at most ``_GN_MAX_CHUNKS`` partials."""
    k = max(1, min(_GN_MAX_CHUNKS, slots // n, rows // (_GN_UNROLL * r)))
    per_chunk = -(-rows // k)
    return -(-rows // per_chunk), per_chunk


def _slots(device: torch.device, dtype: torch.dtype, r: int, v: int) -> int:
    """SMs x the CTAs of R x V threads an SM holds at once (both launches)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, dtype, r, v)
    if key not in _GN_SLOTS:
        per_sm = _build.entry("group_norm", "group_norm_resident_ctas", [ctypes.c_int] * 3)(_GN_DTYPES[dtype], r, v)
        if per_sm <= 0:
            raise RuntimeError(f"group_norm_fused: no occupancy for {r} x {v} threads (code {per_sm})")
        _GN_SLOTS[key] = per_sm * torch.cuda.get_device_properties(index).multi_processor_count
    return _GN_SLOTS[key]


def group_norm_takes(channels: int, num_groups: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes ``channels`` in ``num_groups`` groups of
    ``dtype``: whole 16-byte vectors of channels, at most 512 of them, at
    most 1024 groups of whole channels.  The rest of the rule is the call's
    (``_group_norm_refusal``)."""
    if dtype not in _GN_DTYPES:
        return False
    vec = 16 // dtype.itemsize
    return (channels % vec == 0 and channels // vec <= _GN_THREADS and num_groups <= _GN_MAX_GROUPS
            and channels % num_groups == 0)


def _group_norm_refusal(x, num_groups: int, weight, bias) -> Optional[str]:
    """Why the kernel does not take these operands (None: it does), device
    and gradient apart."""
    if x.dtype not in _GN_DTYPES:
        return f"dtype {x.dtype}"
    if x.ndim < 2 or x.numel() == 0 or x.shape[0] > 65535:
        return f"shape {tuple(x.shape)}"
    c = x.shape[-1]
    if not group_norm_takes(c, num_groups, x.dtype):
        return f"{c} channels in {num_groups} groups"
    for p in (weight, bias):
        if p is None or p.shape != (c,) or p.dtype != weight.dtype or p.dtype not in _GN_DTYPES \
                or p.device != x.device or not p.is_contiguous():
            return "weight and bias must be contiguous (C,) fp32 or bf16, of one dtype, on x's device"
    return None


def fused_group_norm_applies(x, num_groups: int, weight, bias) -> bool:
    """Whether ``models.layers.group_norm`` runs the kernel: x on CUDA, no
    gradient recorded (grad mode off, or none of x, weight and bias
    requires one), and operands the kernel takes."""
    if x.device.type != "cuda":
        return False
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weight, bias)):
        return False
    return _group_norm_refusal(x, num_groups, weight, bias) is None


def group_norm_fused(x, num_groups: int, eps: float, weight, bias, silu: bool = False, absmax: bool = False):
    """``group_norm_plain(x, num_groups, eps, weight, bias, silu)``, and with
    ``absmax`` also ``max |out|`` as a 0-d fp32 tensor on x's device:
    ``(out, absmax)``.  Launches ``csrc/group_norm.cu`` on a CUDA tensor
    (two launches, counted once in ``group_norm_fused.launches``; a strided
    or unaligned x copied first) or raises: every other call takes
    ``models.layers.group_norm``'s composition.  Records no gradient."""
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_fused: unsupported device {x.device}")
    why = _group_norm_refusal(x, num_groups, weight, bias)
    if why is not None:
        raise ValueError(f"group_norm_fused: {why}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)  # the kernel reads (N, rows, C) from an aligned base
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    r, v = group_norm_rows(c, x.element_size(), rows)
    k, per_chunk = group_norm_layout(n, rows, r, _slots(x.device, x.dtype, r, v))
    x, weight, bias = x.detach(), weight.detach(), bias.detach()
    out = torch.empty_like(x)
    partials = torch.empty((n, k, num_groups, 3), dtype=torch.float32, device=x.device)
    peak = torch.empty((), dtype=torch.float32, device=x.device) if absmax else None
    err = _build.entry("group_norm", "group_norm", _GN_ARGTYPES)(
        x.data_ptr(), out.data_ptr(), weight.data_ptr(), bias.data_ptr(), partials.data_ptr(),
        None if peak is None else peak.data_ptr(), _GN_DTYPES[x.dtype], int(weight.dtype == torch.bfloat16),
        n, rows, c, num_groups, k, per_chunk, r, float(eps), int(silu),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err < 0:
        raise ValueError(f"group_norm_fused: refused (code {err}); x {tuple(x.shape)} {x.dtype}, {num_groups} groups")
    if err != 0:
        raise RuntimeError(f"group_norm_fused kernel launch failed with CUDA error {err}")
    group_norm_fused.launches += 1
    return (out, peak) if absmax else out


group_norm_fused.launches = 0
