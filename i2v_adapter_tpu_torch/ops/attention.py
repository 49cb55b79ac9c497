"""Attention ops: plain PyTorch versions and the two hand-written kernels.

Layouts follow the JAX package: spatial attention takes ``q (Bq, Nq, H, D)``
and ``k/v (Bkv, Nk, H, D)`` with ``Bq = Bkv * kv_repeat`` (clip-major,
frame-minor); temporal attention takes ``(B, F, S, C)`` with heads as
contiguous slices of C.

Each kernel wrapper (``flash_attention`` for K1, ``flash_attention_bwd``
for K3, ``temporal_attention_cs`` for K2) launches its CUDA kernel on a CUDA
tensor or raises; a CPU tensor takes the plain version of the same function.
``launches`` on the wrapper counts kernel launches and nothing else.

The JAX package has two more attention kernels that compute the same
functions on other memory layouts: its row-major flash kernel (K5) is
``flash_attention(transposed_io=False)`` here, one CUDA kernel reading both
layouts through strides; its all-of-C temporal kernel (K6), which its forced
``pallas`` impl also runs below 128 tokens, is ``temporal_attention(impl=
"kernel")``, K2's own ``(B, F, S, C)`` layout at every S.

Gradients: ``FlashAttentionFn`` and ``TemporalAttentionFn`` are the
``torch.autograd.Function`` counterparts of the JAX package's custom_vjp
wrappers.  The flash backward runs K3 from the forward's saved log2
logsumexp where ``nk >= FLASH_BWD_MIN_NK``; below it, and in the temporal
backward, autograd differentiates the plain version recomputed in fp32 (the
JAX package has no kernel for those either).  With no gradient recorded, the dispatchers
launch exactly the forward kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from i2v_adapter_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
# key count from which the flash backward runs K3 (the JAX dispatch threshold)
FLASH_BWD_MIN_NK = 1024
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


def _plain_attention(q, k, v, kv_repeat: int, scale: float, static_max: float,
                     with_lse: bool = False):
    """softmax(q k^T scale) v in fp32, probabilities rounded to v's dtype
    before p.v.  ``static_max`` != 0 uses the flash kernel's fixed log2
    offset instead of the row max (rows that underflow entirely go NaN).
    ``with_lse`` also returns the per-row log2-space logsumexp, fp32
    ``(Bq*H, Nq)``, as K1 writes it.  Query batches are taken a few at a
    time so the scores stay under ``_PLAIN_SCORE_BYTES``."""
    bq, nq, h, d = q.shape
    nk = k.shape[1]
    out = torch.empty((bq, nq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bq, h, nq), dtype=torch.float32, device=q.device) if with_lse else None
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
        if with_lse:
            s2 = s * (scale * LOG2E)
            m = static_max if static_max else s2.amax(-1, keepdim=True)
            lse[b0:b1] = (m + torch.log2(torch.exp2(s2 - m).sum(-1, keepdim=True)))[..., 0]
    return (out, lse.view(bq * h, nq)) if with_lse else out


def xla_attention(q, k, v, *, kv_repeat: int = 1, scale: Optional[float] = None):
    """Plain attention (the JAX ``xla_attention``): fp32 softmax."""
    bq, bkv = q.shape[0], k.shape[0]
    if bq != bkv * kv_repeat:
        raise ValueError(f"batch mismatch: {bq} != {bkv} * {kv_repeat}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _plain_attention(q, k, v, kv_repeat, scale, 0.0)


def _row_major(t: torch.Tensor) -> torch.Tensor:
    """``t (B, N, H, D)`` as a view of ``(B, H, N, D)``-contiguous storage
    (no copy when it is stored so already)."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


_FLASH_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]
)
_FLASH_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]
)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_repeat: int = 1,
    scale: Optional[float] = None,
    static_max: float = 0.0,
    with_lse: bool = False,
    transposed_io: bool = True,
):
    """K1: fused attention, read through the strides of (B, N, H, D) views.

    ``transposed_io=False`` is the counterpart of the JAX package's
    row-major kernel (K5, ``_flash_kernel``): the same function on operands
    whose storage is ``(B, H, N, D)``-contiguous, the row-major
    ``(B*H, N, D)`` that kernel reads.  Operands that are not stored so are
    relaid first; the one CUDA kernel then runs on the ``(B, N, H, D)``
    views of that storage, and the result comes back as such a view.  The
    default leaves the operands as the projections give them.

    ``static_max`` != 0 is the log2-space offset used in place of the
    running max (``VideoUNetConfig.flash_static_max``).  ``with_lse`` also
    returns the per-row log2-space logsumexp ``(Bq*H, Nq)`` fp32 that the
    backward (K3) reads: ``static_max + log2(l)`` under the static offset,
    ``m + log2(l)`` otherwise."""
    bq, nq, h, d = q.shape
    bkv, nk, hk, dk = k.shape
    if (h, d) != (hk, dk) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if bq != bkv * kv_repeat:
        raise ValueError(f"batch mismatch: {bq} != {bkv} * {kv_repeat}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not transposed_io:
        q, k, v = (_row_major(t) for t in (q, k, v))
    if q.device.type == "cpu":
        return _plain_attention(q, k, v, kv_repeat, scale, static_max, with_lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    code = _check_kernel_inputs("flash_attention", q, k, v)
    if transposed_io:
        o = torch.empty((bq, nq, h, d), dtype=q.dtype, device=q.device)
    else:
        o = torch.empty((bq, h, nq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((bq * h, nq), dtype=torch.float32, device=q.device) if with_lse else None
    err = _build.entry("flash_attention", "flash_attention_fwd", _FLASH_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None, code,
        bq, nq, nk, h, d, kv_repeat,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        scale * LOG2E, float(static_max),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on_error("flash_attention", err)
    flash_attention.launches += 1
    return (o, lse) if with_lse else o


flash_attention.launches = 0


def _plain_flash_backward(q, k, v, o, g, lse, kv_repeat: int, scale: float):
    """K3's function in plain PyTorch: the flash backward from the forward's
    log2 logsumexp.  Scores are recomputed as K1 computes them
    (``s = (q.k) * scale * log2(e)``), ``p = exp2(s - lse)``,
    ``ds' = p (g.v - rowsum(g*o))``; ``ds'`` is rounded to the inputs' dtype
    before ``ds'.k`` and ``ds'^T.q``, and ``p`` before ``p^T.g``, as the
    Pallas kernels round.  Sums in fp32; query batches are taken a few at a
    time so the scores stay under ``_PLAIN_SCORE_BYTES``, and dk/dv sum the
    ``kv_repeat`` fan-in in fp32 across them."""
    bq, nq, h, d = q.shape
    bkv, nk = k.shape[:2]
    dsum = (g.float() * o.float()).sum(-1).transpose(1, 2)  # (Bq, H, Nq)
    lse3 = lse.view(bq, h, nq)
    dq = torch.empty((bq, nq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.zeros((bkv, nk, h, d), dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    step = max(1, _PLAIN_SCORE_BYTES // max(1, h * nq * nk * 4))
    for b0 in range(0, bq, step):
        b1 = min(bq, b0 + step)
        kv_idx = torch.arange(b0, b1, device=q.device) // kv_repeat
        qs, gs = q[b0:b1].float(), g[b0:b1].float()
        kc, vc = k[kv_idx].float(), v[kv_idx].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qs, kc) * (scale * LOG2E)
        p = torch.exp2(s - lse3[b0:b1, ..., None])
        dp = torch.einsum("bqhd,bkhd->bhqk", gs, vc)
        ds = p * (dp - dsum[b0:b1, ..., None])
        dq[b0:b1] = (torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kc) * scale).to(q.dtype)
        dk.index_add_(0, kv_idx, torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs) * scale)
        dv.index_add_(0, kv_idx, torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), gs))
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, g, lse, *, kv_repeat: int = 1,
                        scale: Optional[float] = None):
    """K3: the flash-attention backward -> ``(dq, dk, dv)``.

    ``o`` and ``lse`` are K1's output and log2 logsumexp for the same
    inputs, ``g`` the gradient of ``o``.  ``dsum = rowsum(g*o)`` is a plain
    reduction here; the kernel recomputes the probabilities tile by tile and
    reduces the ``kv_repeat`` fan-in of dk/dv inside one block, without
    atomics, so the result is the same run to run."""
    bq, nq, h, d = q.shape
    bkv, nk = k.shape[:2]
    if k.shape != v.shape or o.shape != q.shape or g.shape != q.shape or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
                         f" o {tuple(o.shape)} g {tuple(g.shape)}")
    if bq != bkv * kv_repeat or lse.shape != (bq * h, nq):
        raise ValueError(f"batch/lse mismatch: bq={bq} bkv={bkv} kv_repeat={kv_repeat} "
                         f"lse {tuple(lse.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return _plain_flash_backward(q, k, v, o, g, lse, kv_repeat, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd: unsupported device {q.device}")
    code = _check_kernel_inputs("flash_attention_bwd", q, k, v, g)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous fp32 (Bq*H, Nq)")
    dsum = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()  # (Bq, H, Nq)
    dq = torch.empty((bq, nq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((bkv, nk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    err = _build.entry("flash_attention_bwd", "flash_attention_bwd", _FLASH_BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), code,
        bq, nq, nk, h, d, kv_repeat,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
        scale * LOG2E, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on_error("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K1 forward with a gradient (the JAX ``_attention_pallas`` custom_vjp).

    ``flash_bwd`` (``nk >= FLASH_BWD_MIN_NK`` in the dispatch) makes the
    forward also write the log2 logsumexp and save ``(q, k, v, o, lse)``
    for K3; otherwise it saves ``(q, k, v)`` and the backward differentiates
    the plain version recomputed in fp32, the exact softmax whatever offset
    the forward used, as the JAX package's XLA backward does.  The dispatch
    depends on the shape and not on the device, so the CPU runs the same
    path through the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, kv_repeat: int, scale: float, static_max: float, flash_bwd: bool):
        ctx.kv_repeat, ctx.scale, ctx.flash_bwd = kv_repeat, scale, flash_bwd
        if flash_bwd:
            o, lse = flash_attention(q, k, v, kv_repeat=kv_repeat, scale=scale,
                                     static_max=static_max, with_lse=True)
            ctx.save_for_backward(q, k, v, o, lse)
        else:
            o = flash_attention(q, k, v, kv_repeat=kv_repeat, scale=scale, static_max=static_max)
            ctx.save_for_backward(q, k, v)
        return o

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.flash_bwd:
            q, k, v, o, lse = ctx.saved_tensors
            grads = flash_attention_bwd(q, k, v, o, g, lse, kv_repeat=ctx.kv_repeat, scale=ctx.scale)
        else:
            saved = ctx.saved_tensors
            inputs = [t.detach().float().requires_grad_() for t in saved]
            with torch.enable_grad():
                out = xla_attention(*inputs, kv_repeat=ctx.kv_repeat, scale=ctx.scale)
            grads = [d.to(t.dtype) for d, t in zip(torch.autograd.grad(out, inputs, g.float()), saved)]
        return (*grads, None, None, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    text/IP context, as the JAX dispatch does), "kernel", "plain".  Plain
    math takes its gradient from autograd; the kernel from
    ``FlashAttentionFn``."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown impl: {impl}")
    if impl == "plain" or (impl == "auto" and k.shape[1] < 128):
        return xla_attention(q, k, v, kv_repeat=kv_repeat, scale=scale)
    if _needs_grad(q, k, v):
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        return FlashAttentionFn.apply(q, k, v, kv_repeat, scale, static_max,
                                      k.shape[1] >= FLASH_BWD_MIN_NK)
    return flash_attention(q, k, v, kv_repeat=kv_repeat, scale=scale, static_max=static_max)


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
    err = _build.entry("temporal_attention", "temporal_attention_fwd", _TEMPORAL_ARGTYPES)(
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


class TemporalAttentionFn(torch.autograd.Function):
    """K2 forward with a gradient (the JAX ``_temporal_pallas_cs``
    custom_vjp): the backward recomputes the plain version in fp32 and
    differentiates it, as the JAX package does with ``_temporal_ref_mxu``."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int):
        ctx.heads = heads
        ctx.save_for_backward(q, k, v)
        return temporal_attention_cs(q, k, v, heads)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = temporal_attention_plain(*inputs, ctx.heads)
        return (*torch.autograd.grad(out, inputs, g.to(out.dtype)), None)


def temporal_attention(q, k, v, *, heads: int, impl: str = "auto") -> torch.Tensor:
    """Frame-axis self-attention on (B, F, S, C).

    impl: "auto" (the kernel where S >= 128, the einsum below, as the JAX
    dispatch does), "kernel", "plain"."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown impl: {impl}")
    if impl == "plain" or (impl == "auto" and q.shape[2] < 128):
        return temporal_attention_plain(q, k, v, heads)
    if _needs_grad(q, k, v):
        return TemporalAttentionFn.apply(q, k, v, heads)
    return temporal_attention_cs(q, k, v, heads)


_KERNELS = (flash_attention, flash_attention_bwd, temporal_attention_cs)


def reset_launch_counts() -> None:
    for kernel in _KERNELS:
        kernel.launches = 0


def launch_counts() -> dict:
    return {kernel.__name__: kernel.launches for kernel in _KERNELS}
