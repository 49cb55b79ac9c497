"""Device selection shared by the port's entry points.

The card is the default: an entry point given no device runs on CUDA, and
raises when there is none.  Running on the CPU takes an explicit
``device="cpu"`` (the CPU tests pass it); nothing falls back silently.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: i2v_adapter_tpu_torch runs on the GPU by "
                "default; pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

