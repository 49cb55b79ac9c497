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


def rank_device(local_rank: int, device: DeviceLike = None) -> torch.device:
    """The device of a mesh rank: card ``cuda:<local_rank>`` by default
    (raises when the host has fewer cards); an explicit ``device="cpu"``
    keeps every rank on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the mesh's ranks on the CPU")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"rank {local_rank} of this host has no card: {torch.cuda.device_count()} visible")
    return torch.device("cuda", local_rank)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

