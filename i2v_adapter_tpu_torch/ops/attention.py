"""Attention ops: plain PyTorch versions and the two hand-written kernels.

Layouts follow the JAX package: spatial attention takes ``q (Bq, Nq, H, D)``
and ``k/v (Bkv, Nk, H, D)`` with ``Bq = Bkv * kv_repeat`` (clip-major,
frame-minor); temporal attention takes ``(B, F, S, C)`` with heads as
contiguous slices of C.

Each kernel wrapper (``flash_attention`` for K1, ``temporal_attention_cs``
for K2) launches its CUDA kernel on a CUDA tensor or raises; a CPU tensor
takes the plain version of the same function.  ``launches`` on the wrapper
counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from i2v_adapter_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
# largest fp32 score block the plain attention materialises at once
_PLAIN_SCORE_BYTES = 1 << 30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_kernel_inputs(name: str, *tensors: torch.Tensor) -> int:
    t0 = tensors[0]
    if t0.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t0.dtype} not supported (float32, bfloat16)")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: inputs must share device and dtype")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous, strides {t.stride()}")
    return _DTYPE_CODES[t0.dtype]


# negative codes the C entry points return before launching
_REFUSALS = {
    -1: "dtype not supported",
    -2: "head dim not supported",
    -3: "grid too large",
    -4: "bf16 needs a head dim and strides that are multiples of 8 and 16-byte aligned rows",
}


def _raise_on_error(name: str, err: int) -> None:
    if err < 0:
        raise ValueError(f"{name}: {_REFUSALS.get(err, 'refused')} (code {err})")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


# ---------------------------------------------------------------------------
# spatial attention
# ---------------------------------------------------------------------------


def _plain_attention(q, k, v, kv_repeat: int, scale: float, static_max: float):
    """softmax(q k^T scale) v in fp32, probabilities rounded to v's dtype
    before p.v.  ``static_max`` != 0 uses the flash kernel's fixed log2
    offset instead of the row max (rows that underflow entirely go NaN).
    Query batches are taken a few at a time so the scores stay under
    ``_PLAIN_SCORE_BYTES``."""
    bq, nq, h, d = q.shape
    nk = k.shape[1]
    out = torch.empty((bq, nq, h, d), dtype=q.dtype, device=q.device)
    step = max(1, _PLAIN_SCORE_BYTES // max(1, h * nq * nk * 4))
    for b0 in range(0, bq, step):
        b1 = min(bq, b0 + step)
        kv_idx = torch.arange(b0, b1, device=q.device) // kv_repeat
        qc = q[b0:b1].float()
        kc = k[kv_idx].float()
        vc = v[kv_idx]
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kc)
        if static_max:
            p = torch.exp2(s * (scale * LOG2E) - static_max)
            denom = p.sum(-1, keepdim=True)
        else:
            p = torch.softmax(s * scale, dim=-1)
            denom = None
        o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vc.float())
        if denom is not None:
            o = o / denom
        out[b0:b1] = o.transpose(1, 2).to(q.dtype)
    return out


def xla_attention(q, k, v, *, kv_repeat: int = 1, scale: Optional[float] = None):
    """Plain attention (the JAX ``xla_attention``): fp32 softmax."""
    bq, bkv = q.shape[0], k.shape[0]
    if bq != bkv * kv_repeat:
        raise ValueError(f"batch mismatch: {bq} != {bkv} * {kv_repeat}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _plain_attention(q, k, v, kv_repeat, scale, 0.0)


_FLASH_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]
)


def _flash_lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = _FLASH_ARGTYPES
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_repeat: int = 1,
    scale: Optional[float] = None,
    static_max: float = 0.0,
) -> torch.Tensor:
    """K1: fused attention, read through the strides of (B, N, H, D) views.

    ``static_max`` != 0 is the log2-space offset used in place of the
    running max (``VideoUNetConfig.flash_static_max``)."""
    bq, nq, h, d = q.shape
    bkv, nk, hk, dk = k.shape
    if (h, d) != (hk, dk) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if bq != bkv * kv_repeat:
        raise ValueError(f"batch mismatch: {bq} != {bkv} * {kv_repeat}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return _plain_attention(q, k, v, kv_repeat, scale, static_max)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    code = _check_kernel_inputs("flash_attention", q, k, v)
    o = torch.empty((bq, nq, h, d), dtype=q.dtype, device=q.device)
    err = _flash_lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), code,
        bq, nq, nk, h, d, kv_repeat,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        scale * LOG2E, float(static_max),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on_error("flash_attention", err)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_repeat: int = 1,
    scale: Optional[float] = None,
    impl: str = "auto",
    static_max: float = 0.0,
) -> torch.Tensor:
    """Attention entry point of every model site.

    impl: "auto" (the flash kernel when nk >= 128, plain math for the short
    text/IP context, as the JAX dispatch does), "kernel", "plain"."""
    if impl == "plain":
        return xla_attention(q, k, v, kv_repeat=kv_repeat, scale=scale)
    if impl == "kernel":
        return flash_attention(q, k, v, kv_repeat=kv_repeat, scale=scale, static_max=static_max)
    if impl != "auto":
        raise ValueError(f"unknown impl: {impl}")
    if k.shape[1] >= 128:
        return flash_attention(q, k, v, kv_repeat=kv_repeat, scale=scale, static_max=static_max)
    return xla_attention(q, k, v, kv_repeat=kv_repeat, scale=scale)


# ---------------------------------------------------------------------------
# temporal (frame-axis) attention
# ---------------------------------------------------------------------------


def temporal_attention_plain(q, k, v, heads: int) -> torch.Tensor:
    """Einsum frame attention on (B, F, S, C) (the JAX ``_temporal_ref_mxu``):
    fp32 scores and softmax, probabilities in v's dtype, fp32 p.v.  q may
    hold fewer frames than k/v."""
    b, fq, s, c = q.shape
    f = k.shape[1]
    d = c // heads
    qh = q.float().reshape(b, fq, s, heads, d)
    kh = k.float().reshape(b, f, s, heads, d)
    scores = torch.einsum("bfshd,bgshd->bshfg", qh, kh) / math.sqrt(d)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bshfg,bgshd->bfshd", probs, v.float().reshape(b, f, s, heads, d))
    return out.reshape(b, fq, s, c).to(q.dtype)


_TEMPORAL_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_void_p]
)


def _temporal_lib():
    lib = _build.load("temporal_attention")
    if lib.temporal_attention_fwd.argtypes is None:
        lib.temporal_attention_fwd.argtypes = _TEMPORAL_ARGTYPES
        lib.temporal_attention_fwd.restype = ctypes.c_int
    return lib


def temporal_attention_cs(q, k, v, heads: int) -> torch.Tensor:
    """K2: frame attention kernel on q (B, Fq, S, C), k/v (B, F, S, C)."""
    b, fq, s, c = q.shape
    bk, f, sk, ck = k.shape
    if (b, s, c) != (bk, sk, ck) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if c % heads or fq > f:
        raise ValueError(f"bad heads/frames: c={c} heads={heads} fq={fq} f={f}")
    if q.device.type == "cpu":
        return temporal_attention_plain(q, k, v, heads)
    if q.device.type != "cuda":
        raise RuntimeError(f"temporal_attention_cs: unsupported device {q.device}")
    if (c // heads) % 2:
        raise ValueError(f"temporal_attention_cs: the kernel needs an even head dim, got {c // heads}")
    code = _check_kernel_inputs("temporal_attention_cs", q, k, v)
    o = torch.empty((b, fq, s, c), dtype=q.dtype, device=q.device)
    err = _temporal_lib().temporal_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), code,
        b, fq, f, s, c, heads,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        LOG2E / math.sqrt(c // heads),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on_error("temporal_attention_cs", err)
    temporal_attention_cs.launches += 1
    return o


temporal_attention_cs.launches = 0


def temporal_attention(q, k, v, *, heads: int, impl: str = "auto") -> torch.Tensor:
    """Frame-axis self-attention on (B, F, S, C).

    impl: "auto" (the kernel where S >= 128, the einsum below, as the JAX
    dispatch does), "kernel", "plain"."""
    if impl == "plain":
        return temporal_attention_plain(q, k, v, heads)
    if impl == "kernel":
        return temporal_attention_cs(q, k, v, heads)
    if impl != "auto":
        raise ValueError(f"unknown impl: {impl}")
    if q.shape[2] >= 128:
        return temporal_attention_cs(q, k, v, heads)
    return temporal_attention_plain(q, k, v, heads)


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    temporal_attention_cs.launches = 0


def launch_counts() -> dict:
    return {
        "flash_attention": flash_attention.launches,
        "temporal_attention_cs": temporal_attention_cs.launches,
    }
