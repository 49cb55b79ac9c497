"""Serving-mode int8 convolution: the port's copy of the JAX package's
``models/layers.py::int8_conv``, its plain version and the kernels that
compute it on the card.

The function, for channel-last ``x (B, H, W, C)``, an HWIO ``kernel (3, 3,
C, Cout)`` and ``bias (Cout,)``:

    ws = max |kernel| over (kh, kw, cin) / 127          per output channel
    wq = round(kernel / ws)                              int8
    xs = max(max |x|, 1e-12) / 127                       one scalar, the whole tensor
    xq = round(x / xs)                                   int8
    y  = conv(xq, wq)                                    exact int32 sums
    out = (float(y) * (xs * ws) + float(bias)).to(x.dtype)

in fp32 throughout (``kernel`` and ``bias`` are read as they are stored,
cast to fp32, never first to ``x``'s dtype), ``round`` half to even as
``jnp.round``.  ``xs`` covers every image of ``x``: both CFG halves and all
frames of a UNet evaluation share it.  ``xs`` stays a 0-d tensor on the
device: nothing on the path reads it back to the host.

Entry: ``int8_conv(x, kernel, bias, stride=1, padding=1)``; ``padding`` is
1 (SAME for a 3x3 at stride 1, the symmetric stride-2 downsample) or 0
(``VALID``, for an input padded by the caller).  A CPU tensor takes the
plain version (im2col, then an int32 matmul).  A CUDA tensor launches the
kernels or raises:

* stride 1, padding 1 (the resnet and upsample convs):
  ``int8_conv3x3_kernel``, a hand-written implicit-GEMM conv on int8
  ``wgmma`` (``csrc/int8_conv3x3.cu``) that quantises ``x`` while staging
  it, so the int8 activation never reaches device memory; only the abs-max
  pass (one ``aminmax`` read) runs before it, and not even that where the
  caller passes ``absmax`` (the resnets: the fused GroupNorm's);
* any other stride or padding (the stride-2 UNet downsamplers): ``xq``,
  an int8 im2col gathered in PyTorch (pad, nine strided slices, ``cat``),
  then K7 (``ops.profile_int8_dense.int8_matmul``) with its dequantising
  epilogue.

Weights are quantised once per weights version, not per call: each int8
site's OIHW parameter keeps its ``(wq, ws)`` pair, keyed by the parameter's
``data_ptr``, ``_version`` and dtype, and ``int8_conv`` finds it through
the HWIO view the models pass (``cached_weights``), so an in-place write (a
LoRA merge), a reload or a cast rebuilds it at the next
``prepare_weights`` / ``cached_weights``.  ``prepare_weights`` rebuilds every
stale site of a list in one grouped launch on the card
(``quantize_weights``: ``int8_quantize_weights_grouped`` in
``csrc/int8_conv3x3.cu``, one read of each OIHW parameter), straight into
the (Cout, 3, 3, C) = (Cout, 9*C) int8 layout both kernels read, K-major;
the pipeline runs it when it is built, when int8 is switched on and after a
LoRA merge, so serving launches no quantiser.  ``int8_conv`` without a pair
quantises its kernel per call (one grouped launch of one site).

``int8_conv3x3_kernel.launches`` and ``quantize_weights.launches`` count
launches of the two kernels and nothing else.  The plain versions are exact on the card too: the int32
sums (|sum| <= 9 * C * 127^2 < 2^53) are formed as float64 products, in
row chunks.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from i2v_adapter_tpu_torch.ops import _build
from i2v_adapter_tpu_torch.parallel.spmd import shared_activation_scale

# rows of the float64 im2col the plain version multiplies at once on the card
_PLAIN_ROWS = 1 << 16

_OUT_CODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1}

# negative codes the C entry point returns before launching
_REFUSALS = {
    -1: "dtype not supported",
    -3: "too large",
    -4: "needs C a multiple of 16, Cout a multiple of 8 and 16-byte aligned bases",
    -5: "image too wide for the kernel's shared-memory patch",
    -6: "no tensor map for the weights",
}


# ---------------------------------------------------------------------------
# the quantiser and the plain version
# ---------------------------------------------------------------------------


def _div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE division on every device (a Python-scalar
    divisor lets PyTorch's CUDA kernel multiply by the reciprocal instead)."""
    return t / torch.full((), 127.0, device=t.device)


def quantize_weight_plain(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO ``kernel`` -> ``(wq (Cout, 3, 3, C) int8, ws (Cout,) fp32)``:
    per-output-channel symmetric scales from the weights as stored, cast to
    fp32.  ``wq`` is contiguous: the (Cout, 9*C) K-major matrix the kernels
    read, K ordered (ky, kx, c)."""
    # the max of |kernel| is one of its own values, exact in fp32; the
    # division promotes to fp32, as kernel.float() / ws would
    ws = _div127(kernel.abs().amax(dim=(0, 1, 2)).float())
    wq = (kernel / ws).round_().to(torch.int8)
    return wq.permute(3, 0, 1, 2).contiguous(), ws


# one site of the grouped quantiser's table (csrc/int8_conv3x3.cu::QuantEntry)
_QUANT_ENTRY = np.dtype([("w", "<u8"), ("wq", "<u8"), ("ws", "<u8"), ("row0", "<i4"), ("cout", "<i4"),
                         ("c", "<i4"), ("in_dtype", "<i4"), ("vec", "<i4"), ("pad", "<i4")])
_QW_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def quantize_weights(kernels: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``quantize_weight_plain`` of each HWIO kernel (the models pass HWIO
    views of their OIHW parameters); on CUDA tensors from one grouped kernel
    launch for all of them (``int8_quantize_weights_grouped``: one CTA per
    output channel of any site, one read of each OIHW parameter), else the
    plain version.  ``quantize_weights.launches`` counts the launches."""
    kernels = list(kernels)
    if not kernels:
        return []
    dev = kernels[0].device
    if dev.type == "cpu":
        return [quantize_weight_plain(k) for k in kernels]
    if dev.type != "cuda":
        raise RuntimeError(f"quantize_weights: unsupported device {dev}")
    entries = np.zeros(len(kernels), _QUANT_ENTRY)
    outs, params, rows = [], [], 0
    for i, kernel in enumerate(kernels):
        if kernel.device != dev or kernel.dtype not in _IN_CODES or kernel.ndim != 4 \
                or tuple(kernel.shape[:2]) != (3, 3):
            raise TypeError(f"quantize_weights: kernel {tuple(kernel.shape)} {kernel.dtype} on {kernel.device}")
        c, cout = kernel.shape[2], kernel.shape[3]
        w = kernel.detach().permute(3, 2, 0, 1).contiguous()  # OIHW: a view of the models' parameters
        wq = torch.empty((cout, 3, 3, c), dtype=torch.int8, device=dev)
        ws = torch.empty((cout,), dtype=torch.float32, device=dev)
        vec = w.data_ptr() % 16 == 0 and (9 * c * w.element_size()) % 16 == 0
        entries[i] = (w.data_ptr(), wq.data_ptr(), ws.data_ptr(), rows, cout, c, _IN_CODES[w.dtype], vec, 0)
        rows += cout
        params.append(w)  # alive until the launch is queued
        outs.append((wq, ws))
    table = torch.from_numpy(entries.view(np.uint8)).to(dev)
    err = _build.entry("int8_conv3x3", "int8_quantize_weights_grouped", _QW_ARGTYPES)(
        table.data_ptr(), len(kernels), rows, max(9 * k.shape[2] for k in kernels),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err < 0:
        raise ValueError(f"quantize_weights: {_REFUSALS.get(err, 'refused')} (code {err})")
    if err != 0:
        raise RuntimeError(f"quantize_weights kernel launch failed with CUDA error {err}")
    quantize_weights.launches += 1
    return outs


quantize_weights.launches = 0


def quantize_weight(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_weights`` of one kernel."""
    return quantize_weights([kernel])[0]


def weights_key(weight: torch.Tensor) -> tuple:
    """What identifies one version of a parameter's values: its storage, its
    in-place write count and its dtype (an inference tensor has no write
    count: it cannot be written outside inference mode)."""
    try:
        version = weight._version
    except RuntimeError:
        version = None
    return weight.data_ptr(), version, weight.dtype, weight.device


def prepare_weights(params: Sequence[torch.nn.Parameter]) -> int:
    """Quantise every OIHW conv parameter of ``params`` whose cached ``(wq,
    ws)`` pair (kept on the parameter) is missing or stale -- written, cast
    or moved since -- in one grouped launch on the card; returns how many
    were quantised."""
    stale = [w for w in params if w.__dict__.get("_int8_weights", (None,))[0] != weights_key(w)]
    if stale:
        with torch.no_grad():
            pairs = quantize_weights([w.permute(2, 3, 1, 0) for w in stale])
        for w, (wq, ws) in zip(stale, pairs):
            w._int8_weights = (weights_key(w), wq, ws)
    return len(stale)


def drop_weights(params: Sequence[torch.nn.Parameter]) -> None:
    """Forget the cached pairs of ``params`` (int8 switched off)."""
    for w in params:
        w.__dict__.pop("_int8_weights", None)


def cached_weights(kernel: torch.Tensor) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The cached ``(wq, ws)`` of ``kernel`` when it is the HWIO view of an
    OIHW parameter whose weights ``prepare_weights`` quantised (rebuilt here
    first if the parameter changed since); None for any other kernel."""
    base = kernel._base
    if not isinstance(base, torch.nn.Parameter) or "_int8_weights" not in base.__dict__ \
            or kernel.data_ptr() != base.data_ptr() or kernel.stride() != base.permute(2, 3, 1, 0).stride() \
            or kernel.shape != base.permute(2, 3, 1, 0).shape:
        return None
    prepare_weights([base])
    return base._int8_weights[1], base._int8_weights[2]


def absmax_scale(peak: torch.Tensor) -> torch.Tensor:
    """``max(peak, 1e-12) / 127`` as a 0-d fp32 tensor, ``peak`` being max
    |x| (0-d).  Inside a mesh's evaluation ``x`` is this rank's slab, and
    the scale is the MAX over the slabs
    (``parallel.spmd.shared_activation_scale``): the whole tensor's."""
    return shared_activation_scale(_div127(torch.clamp_min(peak.float(), 1e-12)))


def activation_scale(x: torch.Tensor) -> torch.Tensor:
    """``absmax_scale`` of max |x|, from one read of x (``aminmax``)."""
    lo, hi = torch.aminmax(x)
    return absmax_scale(torch.maximum(-lo, hi))


def quantize_activation(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``round(x / xs)`` as int8 (IEEE division, half to even)."""
    return torch.round(x.float() / xs).to(torch.int8)


def dequantize(y: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor, bias: Optional[torch.Tensor],
               dtype: torch.dtype) -> torch.Tensor:
    """``(float(y) * (xs * ws) + float(bias)).to(dtype)``."""
    out = y.float() * (xs * ws)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def _check_padding(padding) -> int:
    if padding not in (0, 1):
        raise ValueError(f"int8_conv: padding must be 1 or 0 (VALID), got {padding!r}")
    return padding


def im2col(xq: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """``(B, Ho, Wo, 9*C)`` patches of a 3x3 conv, K ordered (ky, kx, c):
    pad, nine strided slices, ``cat``."""
    p = _check_padding(padding)
    if p:
        xq = torch.nn.functional.pad(xq, (0, 0, p, p, p, p))
    b, h, w, c = xq.shape
    ho, wo = (h - 3) // stride + 1, (w - 3) // stride + 1
    taps = [xq[:, ky: ky + stride * (ho - 1) + 1: stride, kx: kx + stride * (wo - 1) + 1: stride]
            for ky in range(3) for kx in range(3)]
    return torch.cat(taps, dim=-1)


def int8_conv_int32_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                          padding: int = 1) -> torch.Tensor:
    """The exact int32 conv of int8 ``xq (B, H, W, C)`` with ``wq (Cout, 3,
    3, C)``: im2col then an int32 matmul on the CPU; on the card float64
    products (exact for these sums), image by image in row chunks."""
    cout = wq.shape[0]
    w2 = wq.reshape(cout, -1)
    if xq.device.type == "cpu":
        cols = im2col(xq, stride, padding)
        return (cols.reshape(-1, cols.shape[-1]).to(torch.int32) @ w2.t().to(torch.int32)).reshape(
            cols.shape[:-1] + (cout,))
    wd = w2.t().double()
    outs = []
    for b in range(xq.shape[0]):
        cols = im2col(xq[b: b + 1], stride, padding)
        flat = cols.reshape(-1, cols.shape[-1])
        out = torch.empty((flat.shape[0], cout), dtype=torch.int32, device=xq.device)
        for i in range(0, flat.shape[0], _PLAIN_ROWS):
            out[i: i + _PLAIN_ROWS] = (flat[i: i + _PLAIN_ROWS].double() @ wd).to(torch.int32)
        outs.append(out.reshape(cols.shape[:-1] + (cout,)))
    return torch.cat(outs)


def int8_conv_plain(x, kernel, bias, stride: int = 1, padding: int = 1, weights=None,
                    absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole function in plain PyTorch: quantise, exact int32 conv,
    dequantise (``weights``: ``kernel``'s ``(wq, ws)`` when already
    quantised; ``absmax``: max |x| when already known)."""
    wq, ws = weights if weights is not None else quantize_weight_plain(kernel)
    xs = activation_scale(x) if absmax is None else absmax_scale(absmax)
    y = int8_conv_int32_plain(quantize_activation(x, xs), wq, stride, padding)
    return dequantize(y, xs, ws, bias, x.dtype)


# ---------------------------------------------------------------------------
# the conv kernel's wrapper
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def int8_conv3x3_kernel(x: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                        bias: Optional[torch.Tensor], out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """The stride-1 SAME 3x3 int8 conv of ``x (B, H, W, C)`` (bf16 or fp32)
    with ``wq (Cout, 3, 3, C)`` int8: ``x`` quantised by ``xs`` as it is
    staged, exact int32 sums, then ``y * (xs * ws) + bias`` in
    ``out_dtype`` (default x's dtype), or the raw sums when ``out_dtype`` is
    ``torch.int32``.  A CPU tensor takes the plain version."""
    out_dtype = out_dtype or x.dtype
    if x.ndim != 4 or wq.shape != (wq.shape[0], 3, 3, x.shape[-1]) or wq.dtype != torch.int8:
        raise ValueError(f"int8_conv3x3_kernel: x {tuple(x.shape)} wq {tuple(wq.shape)} {wq.dtype}")
    if x.device.type == "cpu":
        y = int8_conv_int32_plain(quantize_activation(x, xs), wq)
        return y if out_dtype == torch.int32 else dequantize(y, xs, ws, bias, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_conv3x3_kernel: unsupported device {x.device}")
    if x.dtype not in _IN_CODES or out_dtype not in _OUT_CODES:
        raise TypeError(f"int8_conv3x3_kernel: {x.dtype} -> {out_dtype} not supported")
    b, h, w, c = x.shape
    cout = wq.shape[0]
    x = x.contiguous()
    wq = wq.contiguous()
    xs = xs.float().reshape(())
    ws = ws.float().contiguous()
    bias = None if bias is None else bias.float().contiguous()
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    err = _build.entry("int8_conv3x3", "int8_conv3x3", _ARGTYPES)(
        x.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        _IN_CODES[x.dtype], _OUT_CODES[out_dtype], b, h, w, c, cout,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err < 0:
        raise ValueError(f"int8_conv3x3_kernel: {_REFUSALS.get(err, 'refused')} (code {err}); "
                         f"x {tuple(x.shape)} -> Cout {cout}")
    if err != 0:
        raise RuntimeError(f"int8_conv3x3_kernel launch failed with CUDA error {err}")
    int8_conv3x3_kernel.launches += 1
    return out


int8_conv3x3_kernel.launches = 0


def reset_launch_counts() -> None:
    int8_conv3x3_kernel.launches = 0
    quantize_weights.launches = 0


def launch_counts() -> dict:
    return {"int8_conv3x3_kernel": int8_conv3x3_kernel.launches,
            "quantize_weights": quantize_weights.launches}


# ---------------------------------------------------------------------------
# the entry the models call
# ---------------------------------------------------------------------------


def int8_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, stride: int = 1,
              padding: int = 1, absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's ``int8_conv`` (see the module docstring); ``kernel``
    HWIO (the models pass an HWIO view of their OIHW parameter, whose
    quantised pair ``cached_weights`` finds; any other kernel is quantised
    in this call).  ``absmax``: max |x| as a 0-d fp32 tensor when the caller
    has it (the fused GroupNorm returns its output's), so that no
    ``aminmax`` reads x again; the scale is ``absmax_scale`` of it either
    way.  Serving only: no gradient is recorded."""
    if tuple(kernel.shape[:2]) != (3, 3) or kernel.shape[2] != x.shape[-1]:
        raise ValueError(f"int8_conv: x {tuple(x.shape)} kernel {tuple(kernel.shape)}")
    _check_padding(padding)
    weights = cached_weights(kernel)
    if x.device.type == "cpu":
        return int8_conv_plain(x, kernel, bias, stride, padding, weights, absmax)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_conv: unsupported device {x.device}")
    x, kernel, bias = x.detach(), kernel.detach(), bias.detach()
    wq, ws = weights if weights is not None else quantize_weight(kernel)
    xs = activation_scale(x) if absmax is None else absmax_scale(absmax)
    if stride == 1 and padding == 1:
        return int8_conv3x3_kernel(x, wq, xs, ws, bias)
    from i2v_adapter_tpu_torch.ops.profile_int8_dense import int8_matmul

    cols = im2col(quantize_activation(x, xs), stride, padding)
    y = int8_matmul(cols.reshape(-1, cols.shape[-1]), wq.reshape(wq.shape[0], -1).t(),
                    scale=xs, col_scale=ws, bias=bias, out_dtype=x.dtype)
    return y.reshape(cols.shape[:-1] + (wq.shape[0],))
