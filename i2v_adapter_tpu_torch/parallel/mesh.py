"""The serving mesh over a ``torch.distributed`` group (the JAX package's
``parallel/mesh.py``).

The JAX mesh is one controller partitioning one program over a device
array.  The port runs one process per card instead: the processes form a
group (NCCL on the cards, gloo on the CPU), and rank ``r`` takes the mesh
coordinates of JAX device ``r``, the row-major position of ``r`` in the
``(data, fsdp, tensor, seq)`` array that ``create_mesh`` reshapes the
devices into.  Each collective runs over the sub-group of one axis (or of
``data`` x ``seq``); the mesh makes those groups once, every rank calling
``new_group`` in the same order, and keeps the ones it belongs to.  A group
of size 1 is not made: a collective over it is a no-op.
"""

from __future__ import annotations

import datetime
import inspect
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from i2v_adapter_tpu_torch.config import MeshConfig
from i2v_adapter_tpu_torch.device import DeviceLike, rank_device

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, SEQ_AXIS)

# the sub-groups the serving collectives run over
GROUP_AXES = ((DATA_AXIS,), (TENSOR_AXIS,), (SEQ_AXIS,), (DATA_AXIS, SEQ_AXIS))

# a collective that waits longer than this raises (NCCL's watchdog aborts
# the process) instead of hanging every rank
COLLECTIVE_TIMEOUT_S = 600

AxesLike = Union[str, Sequence[str]]


def _axes(axes: AxesLike) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def mesh_shape(config: MeshConfig, n: int) -> Tuple[int, int, int, int]:
    """The ``(data, fsdp, tensor, seq)`` sizes of ``config`` over ``n``
    ranks; one axis of -1 takes the rest, as a reshape wildcard (the JAX
    ``create_mesh``'s rule and errors)."""
    sizes = [config.data, config.fsdp, config.tensor, config.seq]
    known = int(np.prod([s for s in sizes if s != -1]))
    wild = [i for i, s in enumerate(sizes) if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if wild:
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[wild[0]] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {sizes} != {n} devices")
    return tuple(sizes)


def parse_mesh(text: str) -> MeshConfig:
    """``--mesh data,tensor,seq`` (three positive integers) -> MeshConfig
    with ``fsdp=1``, as the JAX CLI and daemon build it."""
    parts = text.split(",")
    try:
        sizes = [int(p) for p in parts]
    except ValueError:
        sizes = []
    if len(sizes) != 3 or len(parts) != 3 or min(sizes) < 1:
        raise ValueError(f"--mesh takes 'data,tensor,seq', three positive integers; got {text!r}")
    return MeshConfig(data=sizes[0], fsdp=1, tensor=sizes[1], seq=sizes[2])


def init_distributed(
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
    device: DeviceLike = None,
) -> Tuple[int, int]:
    """Join the group: the one ``torchrun`` set up (``RANK`` and
    ``WORLD_SIZE`` in the environment) when no rank is given, else rank
    ``rank`` of ``world_size`` at ``init_method`` (``tcp://localhost:<port>``
    or ``file://<path>``).  NCCL when the rank's device is a card, gloo on
    the CPU.  Returns ``(rank, world_size)``; ``(0, 1)`` with no group to
    join.  Already joined: the group's."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if rank is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return 0, 1
        rank, world_size, init_method = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    dev = rank_device(local_rank(rank), device)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if "device_id" in inspect.signature(dist.init_process_group).parameters:
            kwargs["device_id"] = dev  # the communicators made at once, for this card
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method, rank=rank,
                            world_size=world_size, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
                            **kwargs)
    return rank, world_size


def local_rank(rank: int) -> int:
    """The rank's index among the processes of its host (``LOCAL_RANK``
    under ``torchrun``; the rank itself on one host)."""
    return int(os.environ.get("LOCAL_RANK", rank))


class Mesh:
    """This rank's place in the mesh: each axis's size, its coordinates and
    the process groups of the axes it belongs to.  ``control`` is a gloo
    group over all ranks for host messages (the daemon's requests), with no
    timeout that an idle daemon would reach."""

    def __init__(self, shape: Dict[str, int], rank: int, device: torch.device,
                 groups: Dict[Tuple[str, ...], object], control=None):
        self.shape = dict(shape)
        self.rank = rank
        self.device = device
        self.coords = dict(zip(AXES, np.unravel_index(rank, tuple(shape[a] for a in AXES))))
        self.coords = {a: int(i) for a, i in self.coords.items()}
        self._groups = groups
        self.control = control

    def size(self, axes: AxesLike) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def index(self, axes: AxesLike) -> int:
        """This rank's row-major position in the sub-grid of ``axes``."""
        axes = _axes(axes)
        return int(np.ravel_multi_index([self.coords[a] for a in axes], [self.shape[a] for a in axes]))

    def group(self, axes: AxesLike):
        """The process group over ``axes`` that holds this rank; None when
        it has one rank."""
        axes = _axes(axes)
        if self.size(axes) == 1:
            return None
        return self._groups[axes]

    def key(self) -> Tuple[int, ...]:
        """The axis sizes: what a step program compiled for this mesh bakes
        in (the kept step graphs' key)."""
        return tuple(self.shape[a] for a in AXES)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def group_ranks(sizes: Sequence[int], axes: Tuple[str, ...]) -> Iterable[list]:
    """Every group over ``axes``: the ranks that differ only in those axes'
    coordinates, in row-major order, groups ordered by the other axes'
    coordinates (the order every rank makes them in)."""
    ids = np.arange(int(np.prod(sizes))).reshape(sizes)
    keep = [AXES.index(a) for a in axes]
    rest = [i for i in range(len(AXES)) if i not in keep]
    moved = np.transpose(ids, rest + keep).reshape(-1, int(np.prod([sizes[i] for i in keep])))
    return [list(map(int, row)) for row in moved]


def create_mesh(config: MeshConfig = MeshConfig(), device: DeviceLike = None) -> Mesh:
    """This rank's mesh over the joined group (one rank without one).
    Every rank calls it, in the same order as any other group it makes."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    sizes = mesh_shape(config, world)
    groups = {}
    for axes in GROUP_AXES:
        if int(np.prod([sizes[AXES.index(a)] for a in axes])) == 1:
            continue
        for ranks in group_ranks(sizes, axes):
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axes] = group
    control = None
    if world > 1:
        control = dist.new_group(list(range(world)), backend="gloo", timeout=datetime.timedelta(days=365))
    return Mesh(dict(zip(AXES, sizes)), rank, rank_device(local_rank(rank), device), groups, control)


def fsdp_spec(shape, fsdp_size: int, min_size: int = 2**16) -> Tuple[Optional[str], ...]:
    """The JAX ``fsdp_spec`` as a tuple (``()`` replicated, else ``'fsdp'``
    at the largest axis that divides): large parameters shard over the
    ``fsdp`` axis, small ones stay whole.  Used by training over a mesh."""
    if fsdp_size <= 1 or int(np.prod(shape)) < min_size:
        return ()
    best = None
    for i, d in enumerate(shape):
        if d % fsdp_size == 0 and (best is None or d > shape[best]):
            best = i
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = FSDP_AXIS
    return tuple(spec)


def shard(x: torch.Tensor, dim: int, mesh: Mesh, axes: AxesLike) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` over ``axes``."""
    n = mesh.size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    per = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * per, per)


def gather(x: torch.Tensor, dim: int, mesh: Mesh, axes: AxesLike) -> torch.Tensor:
    """The inverse of ``shard``: every rank's block along ``dim``."""
    from i2v_adapter_tpu_torch.parallel.collectives import all_gather

    return all_gather(x, dim, mesh.group(axes))
