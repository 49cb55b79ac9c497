"""3x3 stride-1 SAME convolution of channel-last activations, optionally of
``silu(x*a + s)`` (GroupNorm-apply + SiLU folded into the conv's input read).

Counterpart of the JAX package's ``ops/conv3x3.py``.  Meaning of the
arguments as there: ``x (B, H, W, C)`` channel-last, ``kernel (3, 3, C,
Cout)`` (HWIO), ``bias (Cout,)``, ``pre_scale`` / ``pre_shift`` ``(B, C)``
fp32; the result is ``(B, H, W, Cout)`` in ``x.dtype``:

    out[b,y,x,:] = bias + sum_{dy,dx} act(x[b,y+dy,x+dx,:]) . kernel[dy+1,dx+1]

with ``act(t) = silu(float(t)*a[b] + s[b])`` rounded to ``x.dtype`` (the
identity without a/s), out-of-image taps contributing zero (the padding is
zero *after* the activation), kernel and bias cast to ``x.dtype``, fp32
accumulation, bias added in fp32, one rounding to ``x.dtype``.

``conv3x3_kernel`` is the wrapper of the CUDA kernel (K4,
``csrc/conv3x3.cu``): on a CUDA tensor it launches the kernel or raises, a
CPU tensor takes the plain version; ``launches`` counts kernel launches and
nothing else.  ``conv3x3`` and ``gn_silu_conv3x3`` are the entries the
models call: without a gradient they call the wrapper, with one they go
through ``Conv3x3Fn`` / ``GnSiluConv3x3Fn``, whose backward differentiates
the plain version recomputed from the saved inputs (the JAX package's
custom VJPs take their backward from XLA's conv in the same way; K4 has no
backward kernel).

Weight layout.  The C entry point takes the weights in ``nn.Conv2d``'s own
OIHW storage.  The models pass ``conv.weight.permute(2, 3, 1, 0)``, an HWIO
*view* of that storage, which the wrapper hands on without a copy; a
``kernel`` stored otherwise (a genuinely HWIO-contiguous array) is copied
once per call.  The bf16 path then repacks the weights per tap into scratch
memory with a small kernel of its own before every launch.  That is a repack
per call, not a cache: a changed or re-loaded parameter is read afresh, at
the cost of moving the weights twice (59 MB at 2560 -> 1280, bf16), which is
part of the wrapper's measured time.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from i2v_adapter_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# negative codes the C entry point returns before launching
_REFUSALS = {
    -1: "dtype not supported",
    -3: "grid too large",
    -4: "bf16 needs C and Cout that are multiples of 8 and 16-byte aligned rows",
    -5: "image too wide for the kernel's shared-memory patch",
    -6: "no tensor map for the packed weights",
}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def conv3x3_plain(x, kernel, bias) -> torch.Tensor:
    """``F.conv2d`` on the NCHW view (a channels-last tensor, no copy)."""
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, bias.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


def gn_silu_conv3x3_plain(x, pre_scale, pre_shift, kernel, bias) -> torch.Tensor:
    """``conv3x3_plain(silu(x*a + s))``, the activation in fp32 and rounded
    to x's dtype before the conv."""
    xf = x.float() * pre_scale[:, None, None, :] + pre_shift[:, None, None, :]
    return conv3x3_plain(F.silu(xf).to(x.dtype), kernel, bias)


# ---------------------------------------------------------------------------
# K4 wrapper
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check_shapes(x, kernel, bias, pre_scale, pre_shift) -> None:
    if x.ndim != 4 or kernel.ndim != 4 or tuple(kernel.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} kernel {tuple(kernel.shape)}")
    if tuple(bias.shape) != (kernel.shape[-1],):
        raise ValueError(f"bias {tuple(bias.shape)} for kernel {tuple(kernel.shape)}")
    if (pre_scale is None) != (pre_shift is None):
        raise ValueError("pre_scale and pre_shift come together")
    if pre_scale is not None:
        want = (x.shape[0], x.shape[-1])
        if tuple(pre_scale.shape) != want or tuple(pre_shift.shape) != want:
            raise ValueError(f"pre_scale/pre_shift must be {want}, got "
                             f"{tuple(pre_scale.shape)} / {tuple(pre_shift.shape)}")


def conv3x3_kernel(x, kernel, bias, pre_scale=None, pre_shift=None) -> torch.Tensor:
    """K4: the conv (of ``silu(x*pre_scale + pre_shift)`` when the two
    vectors are given) in one kernel.  No gradient is recorded through the
    launch; ``conv3x3`` / ``gn_silu_conv3x3`` add one."""
    _check_shapes(x, kernel, bias, pre_scale, pre_shift)
    if x.device.type == "cpu":
        if pre_scale is None:
            return conv3x3_plain(x, kernel, bias)
        return gn_silu_conv3x3_plain(x, pre_scale, pre_shift, kernel, bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3x3_kernel: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"conv3x3_kernel: dtype {x.dtype} not supported (float32, bfloat16)")
    b, h, w, c = x.shape
    cout = kernel.shape[-1]
    x = x.detach().contiguous()
    # OIHW storage: a view for the models' weights, one copy for others
    w_oihw = kernel.detach().to(x.dtype).permute(3, 2, 0, 1).contiguous()
    bias = bias.detach().to(x.dtype).contiguous()
    if pre_scale is not None:
        pre_scale = pre_scale.detach().float().contiguous()
        pre_shift = pre_shift.detach().float().contiguous()
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    # scratch for the bf16 path's [tap][Cout][C] repack of this call's weights
    wpack = torch.empty((9, cout, c), dtype=x.dtype, device=x.device) if x.dtype == torch.bfloat16 else None
    err = _build.entry("conv3x3", "conv3x3_fwd", _ARGTYPES)(
        x.data_ptr(), None if pre_scale is None else pre_scale.data_ptr(),
        None if pre_shift is None else pre_shift.data_ptr(),
        w_oihw.data_ptr(), None if wpack is None else wpack.data_ptr(), bias.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[x.dtype],
        b, h, w, c, cout, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err < 0:
        raise ValueError(f"conv3x3_kernel: {_REFUSALS.get(err, 'refused')} (code {err})")
    if err != 0:
        raise RuntimeError(f"conv3x3_kernel launch failed with CUDA error {err}")
    conv3x3_kernel.launches += 1
    return out


conv3x3_kernel.launches = 0


def reset_launch_counts() -> None:
    conv3x3_kernel.launches = 0


def launch_counts() -> dict:
    return {"conv3x3_kernel": conv3x3_kernel.launches}


# ---------------------------------------------------------------------------
# gradients and the entries the models call
# ---------------------------------------------------------------------------


def _plain_vjp(plain, saved, needs, g):
    """Gradients of ``plain(*saved)`` w.r.t. the inputs marked in ``needs``
    (None elsewhere), the plain version recomputed under autograd."""
    inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
    with torch.enable_grad():
        out = plain(*inputs)
    wanted = [t for t, n in zip(inputs, needs) if n]
    grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
    return tuple(next(grads) if n else None for n in needs)


class Conv3x3Fn(torch.autograd.Function):
    """K4 (unfused) forward; backward of the plain conv, recomputed."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel, bias)
        return conv3x3_kernel(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(conv3x3_plain, ctx.saved_tensors, ctx.needs_input_grad, g)


class GnSiluConv3x3Fn(torch.autograd.Function):
    """K4 (fused) forward; backward of ``conv(silu(x*a + s))`` in plain
    PyTorch, recomputed, for whichever of x, a, s, kernel, bias need it."""

    @staticmethod
    def forward(ctx, x, pre_scale, pre_shift, kernel, bias):
        ctx.save_for_backward(x, pre_scale, pre_shift, kernel, bias)
        return conv3x3_kernel(x, kernel, bias, pre_scale, pre_shift)

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(gn_silu_conv3x3_plain, ctx.saved_tensors, ctx.needs_input_grad, g)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def conv3x3(x, kernel, bias) -> torch.Tensor:
    """3x3 stride-1 SAME conv through K4."""
    if _needs_grad(x, kernel, bias):
        return Conv3x3Fn.apply(x, kernel, bias)
    return conv3x3_kernel(x, kernel, bias)


def gn_silu_conv3x3(x, pre_scale, pre_shift, kernel, bias) -> torch.Tensor:
    """GroupNorm-apply + SiLU + 3x3 conv through K4: the ``(B, C)`` vectors
    come from the caller (``ops.norms.fold_gn_affine``); x is read once."""
    if _needs_grad(x, pre_scale, pre_shift, kernel, bias):
        return GnSiluConv3x3Fn.apply(x, pre_scale, pre_shift, kernel, bias)
    return conv3x3_kernel(x, kernel, bias, pre_scale, pre_shift)


# ---------------------------------------------------------------------------
# the reference's shape gate
# ---------------------------------------------------------------------------


def _pick_co_block(c: int, cout: int, itemsize: int) -> int:
    budget = 4 * 1024 * 1024
    if 9 * c * cout * itemsize <= budget:
        return cout
    best = 0
    for co in range(128, cout + 1, 128):
        if cout % co == 0 and 9 * c * co * itemsize <= budget:
            best = co
    return best


def conv3x3_supported(x: torch.Tensor, kernel: torch.Tensor) -> bool:
    """The JAX package's shape gate for its fused conv under ``'auto'``,
    kept answer for answer (3x3, at least 128 input channels, channel counts
    that are multiples of 8, a weight block it could tile).  The port's
    ``conv_impl='pallas'`` forces the kernel, as the reference's does, and
    nothing in the port consults the gate to choose a path."""
    if kernel.ndim != 4 or tuple(kernel.shape[:2]) != (3, 3):
        return False
    b, h, w, c = x.shape
    cout = kernel.shape[-1]
    if c < 128 or c % 8 or cout % 8:
        return False
    if _pick_co_block(c, cout, x.element_size()) == 0:
        return False
    return (w * c * x.element_size()) % 1024 == 0 or (h * w) % 8 == 0
