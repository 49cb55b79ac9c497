"""Seeded weights, made on the device in one draw per dtype.

The benchmark makes every weight itself and hands the same tensors to the
program under test and to the reference.  The names and shapes come from
the reference's modules (``reference.model.build``); the program's modules
must have exactly the same set.  The values follow the fan-in rule of
seeded smoke runs, so activations stay of order one at full width:
matrices and kernels N(0, 1 / fan_in), norm scales 1 + 0.1 N, other vectors
0.1 N.  One ``torch.randn`` per dtype fills a flat buffer on the device;
each weight is a view into it, 256-byte aligned, scaled in place.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn as nn

Spec = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
# each weight starts on this boundary, as an allocation of its own would:
# the library matmuls take their fast paths only on aligned operands
ALIGN_BYTES = 256


def spec_of(models: Dict[str, nn.Module], dtype_of: Callable[[str], torch.dtype]) -> Spec:
    """``{"<model>.<param>": (shape, dtype)}`` of meta-device modules."""
    return {f"{m}.{n}": (tuple(p.shape), dtype_of(f"{m}.{n}"))
            for m, module in models.items() for n, p in module.named_parameters()}


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``spec`` from ``seed``: one draw per dtype, in sorted
    name order, so the same spec and seed give the same values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for dtype in sorted({d for _, d in spec.values()}, key=str):
        names = sorted(n for n, (_, d) in spec.items() if d == dtype)
        align = ALIGN_BYTES // torch.empty((), dtype=dtype).element_size()
        starts, total = {}, 0
        for n in names:
            starts[n] = total
            total += -(-math.prod(spec[n][0]) // align) * align
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        with torch.no_grad():
            for n in names:
                shape = spec[n][0]
                size = math.prod(shape)
                w = flat[starts[n]:starts[n] + size].view(shape)
                if len(shape) >= 2:
                    w.mul_(1.0 / math.sqrt(size // shape[0]))
                elif n.endswith("weight"):
                    w.mul_(0.1).add_(1.0)
                else:
                    w.mul_(0.1)
                out[n] = w
    return out


def load(models: Dict[str, nn.Module], weights: Dict[str, torch.Tensor], dtype=None,
         trainable: Callable[[str], bool] = lambda name: False) -> None:
    """Put ``weights`` into the parameters of ``models`` (cast to ``dtype``
    when given, else as they are).  Every parameter must have a weight of
    its shape, and every weight a parameter."""
    seen = set()
    for m, module in models.items():
        for n, p in list(module.named_parameters()):
            key = f"{m}.{n}"
            if key not in weights:
                raise KeyError(f"no weight for {key}")
            w = weights[key]
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"{key}: weight {tuple(w.shape)} vs parameter {tuple(p.shape)}")
            owner, _, leaf = n.rpartition(".")
            target = module.get_submodule(owner) if owner else module
            w = w if dtype is None else w.to(dtype)
            target._parameters[leaf] = nn.Parameter(w, requires_grad=trainable(key))
            seen.add(key)
    missing = set(weights) - seen
    if any(k.split(".", 1)[0] in models for k in missing):
        raise KeyError(f"weights without a parameter: {sorted(missing)[:5]}")

