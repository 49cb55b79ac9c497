"""Microbenchmark: int8 options for the transformer's dense matmuls.

Counterpart of the JAX package's ``ops/profile_int8_dense.py``.  At the
UNet's projection / feed-forward shapes (512 px, 16 frames, CFG: B*F = 32)
it times three ways to the same product:

  bf16          -- ``x @ w`` in bf16, the serving path
  int8 library  -- dynamic per-tensor quantisation + ``torch._int_mm`` +
                   dequantisation; the library yardstick, used nowhere else
  int8 kernel   -- ``int8_pallas``: the same quantisation around K7
                   (``csrc/int8_matmul.cu``), a hand-written int8 ``wgmma``
                   matmul with int32 accumulation and a dequantising epilogue

The reference's fourth column, an int8 1x1 convolution, has no PyTorch
counterpart on CUDA without a package of finished kernels (cuDNN's int8
convolutions are not reachable from ``F.conv2d``), so it is left out.

Weight layout.  For 8-bit operands the tensor cores read both operands
K-major, so K7 wants the (K, N) weight stored K-contiguous, as
``wq.t().contiguous().t()``.  Weights are static, so the tool prepares that
layout once, outside the timed calls, and times ``torch._int_mm`` in both
layouts (row-major ``wq`` and the K-major one) beside K7 on the K-major
one; K7 on the row-major operand packs it per call, inside its time.

    python -m i2v_adapter_tpu_torch.ops.profile_int8_dense [--shapes N] [--device cpu]

prints the card's name and power limit, then one row per shape.  It runs on
the card unless ``--device cpu`` is given, which checks the plain math at a
cut size and reports host times under that name.

``int8_matmul`` is K7's wrapper: on a CUDA tensor it launches the kernel or
raises, a CPU tensor takes the plain version; ``launches`` counts launches.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from typing import Optional

import torch

from i2v_adapter_tpu_torch.ops import _build

# (M, K, N) of the dense sites at 512 px / 16 frames, CFG-doubled (B*F = 32):
# QKV / out projections and the GEGLU feed-forward at each UNet level.
SHAPES = [
    (32 * 4096, 320, 320),    # L0 qkv/out
    (32 * 4096, 320, 960),    # L0 fused qkv
    (32 * 4096, 320, 640),    # L0 fused kv
    (32 * 4096, 320, 2560),   # L0 ff in (geglu 2*4*dim)
    (32 * 4096, 1280, 320),   # L0 ff out
    (32 * 1024, 640, 640),    # L1 qkv/out
    (32 * 1024, 640, 1920),   # L1 fused qkv
    (32 * 1024, 640, 5120),   # L1 ff in
    (32 * 1024, 2560, 640),   # L1 ff out
    (32 * 256, 1280, 1280),   # L2/L3 qkv/out
    (32 * 256, 1280, 3840),   # L2 fused qkv
    (32 * 256, 1280, 10240),  # L2 ff in
    (32 * 256, 5120, 1280),   # L2 ff out
]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
_OUT_CODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 product: an int32 matmul on the CPU; on the card a
    float64 product, which holds these sums (|sum| <= K * 127^2 < 2^53)
    exactly."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ wq.to(torch.int32)
    return (xq.double() @ wq.double()).to(torch.int32)


def dequantize(y, scale, col_scale, bias, dtype):
    """``(float(y) * (scale * col_scale) + float(bias)).to(dtype)``, the
    epilogue of K7's dequantising mode (bias optional)."""
    out = y.float() * (scale * col_scale)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, *, scale: Optional[torch.Tensor] = None,
                col_scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K7: ``(M, K) int8 @ (K, N) int8 -> (M, N) int32``; with ``scale`` (a
    0-d fp32 tensor, the activation's) and ``col_scale`` (N,) the
    dequantised ``y * (scale * col_scale) + bias`` in ``out_dtype`` (default
    bf16) from the same launch.  ``wq`` stored K-contiguous (a transposed
    view of an (N, K) tensor) is read in place; another layout is packed to
    it first, inside this call."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_matmul: int8 operands, got {xq.dtype} and {wq.dtype}")
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0] or xq.device != wq.device:
        raise ValueError(f"int8_matmul: shapes {tuple(xq.shape)} @ {tuple(wq.shape)}")
    if (scale is None) != (col_scale is None):
        raise ValueError("int8_matmul: scale and col_scale come together")
    dequant = scale is not None
    out_dtype = (out_dtype or torch.bfloat16) if dequant else torch.int32
    if xq.device.type == "cpu":
        y = int8_matmul_plain(xq, wq)
        return dequantize(y, scale, col_scale, bias, out_dtype) if dequant else y
    if xq.device.type != "cuda":
        raise RuntimeError(f"int8_matmul: unsupported device {xq.device}")
    if out_dtype not in _OUT_CODES or (dequant and out_dtype == torch.int32):
        raise TypeError(f"int8_matmul: output dtype {out_dtype} not supported")
    m, k = xq.shape
    n = wq.shape[1]
    xq = xq.contiguous()
    wt = wq.t().contiguous()  # (N, K) K-contiguous: a view when wq is stored so
    if dequant:
        scale = scale.float().reshape(())
        col_scale = col_scale.float().contiguous()
        bias = None if bias is None else bias.float().contiguous()
    # the kernel's TMA stores need 16-byte rows: a width that is not gets a
    # padded row pitch, and the result is the (M, N) view of it
    per16 = 16 // (2 if out_dtype == torch.bfloat16 else 4)
    ldo = -(-n // per16) * per16
    out = torch.empty((m, ldo), dtype=out_dtype, device=xq.device)
    err = _build.entry("int8_matmul", "int8_matmul", _ARGTYPES)(
        xq.data_ptr(), wt.data_ptr(), out.data_ptr(), m, k, n, ldo, _OUT_CODES[out_dtype],
        scale.data_ptr() if dequant else None, col_scale.data_ptr() if dequant else None,
        bias.data_ptr() if bias is not None else None,
        torch.cuda.current_stream(xq.device).cuda_stream,
    )
    if err < 0:
        raise ValueError(f"int8_matmul: refused (code {err}): K must be a multiple of 16 and the "
                         f"bases 16-byte aligned; got {m}x{k}x{n}")
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed with CUDA error {err}")
    int8_matmul.launches += 1
    return out if ldo == n else out[:, :n]


int8_matmul.launches = 0


def quantize_weight(wf: torch.Tensor):
    """Per-output-column symmetric int8: ``(wq (K, N) int8, ws (N,) fp32)``."""
    ws = wf.float().abs().amax(0) / 127.0
    return torch.round(wf.float() / ws).to(torch.int8), ws


def _quantize_activation(x: torch.Tensor):
    xs = x.float().abs().amax().clamp_min(1e-12) / 127.0
    return torch.round(x.float() / xs).to(torch.int8), xs


def bf16_dot(x, w, ws=None):
    return x @ w


def int8_pallas(x, wq, ws):
    """Dynamic per-tensor activation scale, K7 with its per-column
    dequantising epilogue; bf16 result (the reference's ``int8_pallas``)."""
    xq, xs = _quantize_activation(x)
    return int8_matmul(xq, wq, scale=xs, col_scale=ws, out_dtype=torch.bfloat16)


def int8_library(x, wq, ws):
    """The same quantisation around ``torch._int_mm``: the yardstick."""
    xq, xs = _quantize_activation(x)
    return (torch._int_mm(xq, wq).float() * (xs * ws)).to(torch.bfloat16)


def _device_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def run(shapes, device, iters: int = 10, seed: int = 0):
    """One dict per shape: times of the three columns and of the bare
    matmuls (K7 on the K-major weights prepared in setup and on row-major
    ones, packed per call; ``torch._int_mm`` on both), K7's equality with the
    exact product, and the composite's error against the bf16 product.  On
    the CPU the times are host times of the plain math."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    timed = _device_ms if on_card else _host_ms
    rows = []
    for m, k, n in shapes:
        g = torch.Generator(device=dev).manual_seed(seed + (m * k * n) % (1 << 31))
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        wf = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
        wq, ws = quantize_weight(wf)
        wq_km = wq.t().contiguous().t()  # the K-major layout, prepared once
        wb = wf.to(torch.bfloat16)
        xq, _ = _quantize_activation(x)
        before = int8_matmul.launches
        got = int8_matmul(xq, wq_km)
        launched = int8_matmul.launches - before
        want = int8_matmul_plain(xq, wq)
        row = {"m": m, "k": k, "n": n, "flops": 2 * m * k * n,
               "exact": bool(torch.equal(got, want) and torch.equal(int8_matmul(xq, wq), want)),
               "launched_kernel": launched == 1}
        ref = (x.float() @ wb.float()) if not on_card else (x @ wb).float()
        y = int8_pallas(x, wq_km, ws).float()
        row["int8_vs_bf16_rel_err"] = float((y - ref).abs().max() / ref.abs().max())
        unit = "ms" if on_card else "host_ms"
        row[f"bf16_{unit}"] = timed(lambda: bf16_dot(x, wb), iters)
        row[f"int8_kernel_{unit}"] = timed(lambda: int8_pallas(x, wq_km, ws), iters)
        row[f"k7_matmul_{unit}"] = timed(lambda: int8_matmul(xq, wq_km), iters)
        row[f"k7_matmul_rowmajor_{unit}"] = timed(lambda: int8_matmul(xq, wq), iters)
        if on_card:
            row["int8_library_ms"] = timed(lambda: int8_library(x, wq_km, ws), iters)
            row["int_mm_ms"] = timed(lambda: torch._int_mm(xq, wq), iters)
            row["int_mm_kmajor_ms"] = timed(lambda: torch._int_mm(xq, wq_km), iters)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", type=int, default=len(SHAPES),
                    help="time only the first N of the 13 shapes")
    ap.add_argument("--device", default=None, choices=["cpu"],
                    help="'cpu': plain math at 1/64 of each M, host times")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    shapes = SHAPES[: args.shapes]
    if args.device == "cpu":
        print("cpu (plain math; host times, not device times)")
        rows = run([(m // 64, k, n) for m, k, n in shapes], "cpu", iters=1)
    else:
        if not torch.cuda.is_available():
            print("profile_int8_dense: needs a CUDA device (or --device cpu)", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable")
        rows = run(shapes, "cuda", iters=args.iters)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["exact"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
