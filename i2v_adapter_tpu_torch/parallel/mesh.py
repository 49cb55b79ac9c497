"""The serving and training mesh over a ``torch.distributed`` group (the
JAX package's ``parallel/mesh.py``).

The JAX mesh is one controller partitioning one program over a device
array.  The port runs one process per card instead: the processes form a
group (NCCL on the cards, gloo on the CPU), and rank ``r`` takes the mesh
coordinates of JAX device ``r``, the row-major position of ``r`` in the
``(data, fsdp, tensor, seq)`` array that ``create_mesh`` reshapes the
devices into.  Each collective runs over the sub-group of one axis (or of
``data`` x ``seq``); the mesh makes those groups once, every rank calling
``new_group`` in the same order, and keeps the ones it belongs to.  A group
of size 1 is not made: a collective over it is a no-op.

Training adds the JAX ``batch_sharding``'s counterpart (``batch_rows``,
``local_batch``: the rows of the global batch a rank's ``(data, fsdp)``
block holds and the frames its ``seq`` index holds) and the ZeRO rules
(``train_state_shardings``: one spec per train-state leaf under its
Flax-tree name, as the JAX function answers; ``parallel.zero`` applies
them).
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

# the sub-groups the collectives run over, made in this order on every rank:
# serving's (data, tensor, seq, the evaluation's data x seq), then
# training's: the ZeRO shards (fsdp), the clip axes (data x fsdp), the
# axes a replicated gradient is summed over (data x fsdp x seq)
GROUP_AXES = ((DATA_AXIS,), (TENSOR_AXIS,), (SEQ_AXIS,), (DATA_AXIS, SEQ_AXIS), (FSDP_AXIS,),
              (DATA_AXIS, FSDP_AXIS), (DATA_AXIS, FSDP_AXIS, SEQ_AXIS))
# the axes a training batch's clips are split over (the JAX batch_sharding's
# dim 0), and those a trainable's gradient is summed over
CLIP_AXES = (DATA_AXIS, FSDP_AXIS)
GRAD_AXES = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS)
# the ranks of one (data, fsdp) block: the same clips, split otherwise
BLOCK_AXES = (TENSOR_AXIS, SEQ_AXIS)

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
    timeout that an idle daemon would reach; ``block_control`` a gloo group
    over the ranks of this rank's ``(data, fsdp)`` block (its ``tensor`` x
    ``seq`` ranks, which train on the same clips), None when it has one."""

    def __init__(self, shape: Dict[str, int], rank: int, device: torch.device,
                 groups: Dict[Tuple[str, ...], object], control=None, block_control=None):
        self.shape = dict(shape)
        self.rank = rank
        self.device = device
        self.block_control = block_control
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


def create_mesh(config: MeshConfig = MeshConfig(), device: DeviceLike = None,
                members: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """This rank's mesh over the joined group (one rank without one), or
    over the ranks ``members`` of it (mesh rank ``i`` is ``members[i]``;
    ``None`` on a rank outside them, as a bench of several mesh sizes on
    one world needs).  Every rank of the group calls it, in the same order
    as any other group it makes."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    members = list(range(world)) if members is None else [int(r) for r in members]
    sizes = mesh_shape(config, len(members))
    groups, made = {}, {}
    for axes in GROUP_AXES:
        if int(np.prod([sizes[AXES.index(a)] for a in axes])) == 1:
            continue
        for ranks in group_ranks(sizes, axes):
            ranks = tuple(members[i] for i in ranks)
            if ranks not in made:  # axes of size 1 give the same ranks: one communicator
                made[ranks] = dist.new_group(list(ranks))
            if rank in ranks:
                groups[axes] = made[ranks]
    control = block_control = None
    if len(members) > 1:
        control = dist.new_group(members, backend="gloo", timeout=datetime.timedelta(days=365))
    if int(np.prod([sizes[AXES.index(a)] for a in BLOCK_AXES])) > 1:
        for ranks in group_ranks(sizes, BLOCK_AXES):
            ranks = [members[i] for i in ranks]
            group = dist.new_group(ranks, backend="gloo", timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
            block_control = group if rank in ranks else block_control
    if rank not in members:
        return None
    return Mesh(dict(zip(AXES, sizes)), members.index(rank), rank_device(local_rank(rank), device), groups,
                control, block_control)


def fsdp_spec(shape, fsdp_size: int, min_size: int = 2**16) -> Tuple[Optional[str], ...]:
    """The JAX ``fsdp_spec`` as a tuple (``()`` replicated, else ``'fsdp'``
    at the largest axis that divides, the first on a tie): large parameters
    shard over the ``fsdp`` axis, small ones stay whole.  ``shape`` is the
    Flax layout's, as the JAX rule sees it."""
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


def spec_dim(spec: Tuple[Optional[str], ...], axis: str = FSDP_AXIS) -> Optional[int]:
    """The dim of a spec sharded over ``axis``; None when it is not."""
    return spec.index(axis) if axis in spec else None


# ---------------------------------------------------------------------------
# training: the batch's layout and the train state's placement
# ---------------------------------------------------------------------------


def batch_rows(mesh: Mesh, batch_size: int) -> Tuple[int, int]:
    """``[lo, hi)``: the rows of a global batch of ``batch_size`` clips this
    rank's ``(data, fsdp)`` block holds (the JAX ``batch_sharding``'s dim 0
    over ``data`` x ``fsdp``, row-major)."""
    ways = mesh.size(CLIP_AXES)
    if batch_size % ways:
        raise ValueError(f"batch {batch_size} does not split over data x fsdp = {ways}")
    per = batch_size // ways
    lo = mesh.index(CLIP_AXES) * per
    return lo, lo + per


def frame_range(mesh: Mesh, frames: int) -> Tuple[int, int]:
    """``[lo, hi)``: the frames of each clip this rank's ``seq`` index holds."""
    s = mesh.size(SEQ_AXIS)
    if frames % s:
        raise ValueError(f"{frames} frames do not split over seq = {s}")
    per = frames // s
    lo = mesh.index(SEQ_AXIS) * per
    return lo, lo + per


def local_batch(batch: dict, mesh: Mesh, video: bool = True) -> dict:
    """This rank's part of a global training batch (``pixel_values`` (B, F,
    ...), ``text_ids`` / ``uncond_ids`` (B, L), ``clip_image`` (B, ...), as
    arrays or tensors): its block's rows, and of ``pixel_values`` its
    ``seq`` index's frames when ``video`` (t2i pixels have no frame dim)."""
    lo, hi = batch_rows(mesh, len(batch["pixel_values"]))
    out = {k: v[lo:hi] for k, v in batch.items()}
    if video:
        f0, f1 = frame_range(mesh, out["pixel_values"].shape[1])
        out["pixel_values"] = out["pixel_values"][:, f0:f1]
    return out


# the TrainState fields that hold no-gradient weights (the JAX
# _FROZEN_STATE_FIELDS)
FROZEN_STATE_FIELDS = ("frozen", "vae", "text_encoder", "image_encoder")


def state_leaf_spec(name: str, shape, mesh_shape: Dict[str, int], min_size: int = 2**16,
                    frozen_replicated: bool = False) -> Tuple[Optional[str], ...]:
    """The JAX ``train_state_shardings`` rule for one leaf: ``name`` its
    ``/``-joined Flax-tree name (``trainable/...``, ``opt_state/mu/...``,
    ``frozen/...``, ``vae/...``), ``shape`` its Flax layout's.  Under
    ``tensor`` the attention projections follow the Megatron rules
    (``spmd._tp_spec``); with ``frozen_replicated`` the no-gradient fields
    stay whole; every other leaf follows ``fsdp_spec``."""
    from i2v_adapter_tpu_torch.parallel.spmd import _tp_spec

    keys = tuple(name.split("/"))
    shape = tuple(shape)
    tsize = mesh_shape.get(TENSOR_AXIS, 1)
    if tsize > 1:
        spec = _tp_spec(keys, shape, tsize, heads=0)
        if spec != ():
            return spec
    if frozen_replicated and keys[0] in FROZEN_STATE_FIELDS:
        return ()
    return fsdp_spec(shape, mesh_shape.get(FSDP_AXIS, 1), min_size)


def train_state_shardings(state, mesh, min_size: int = 2**16,
                          frozen_replicated: bool = False) -> Dict[str, Tuple[Optional[str], ...]]:
    """One spec per tensor of a ``TrainState`` (``()`` replicated, else the
    axis name at each sharded dim of its Flax layout), keyed by its Flax-tree
    name as ``training.checkpoint.train_state_tensors`` names it: the JAX
    ``train_state_shardings`` answer for the same leaf.  ``mesh`` is a
    ``Mesh`` or its axis sizes; a placed state answers for its whole
    leaves."""
    from i2v_adapter_tpu_torch.training.checkpoint import train_state_tensors

    shape = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    zero = getattr(state, "zero", None)
    out = {}
    for name, t in train_state_tensors(state).items():
        full = zero.full_flax_shape(name, t) if zero is not None else tuple(t.shape)
        out[name] = state_leaf_spec(name, full, shape, min_size, frozen_replicated)
    return out


def shard_params_fsdp(shapes: Dict[str, tuple], mesh, min_size: int = 2**16) -> Dict[str, Tuple]:
    """``fsdp_spec`` of every leaf of ``{name: Flax-layout shape}`` (the JAX
    ``shard_params_fsdp`` over a parameter tree)."""
    size = (mesh.shape if isinstance(mesh, Mesh) else dict(mesh)).get(FSDP_AXIS, 1)
    return {name: fsdp_spec(shape, size, min_size) for name, shape in shapes.items()}
