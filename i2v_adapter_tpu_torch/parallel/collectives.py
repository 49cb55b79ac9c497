"""The collectives of serving over a mesh.

In the JAX package these are inserted by GSPMD (and by ``shard_map``'s
explicit ``all_gather``); the port states each one where its layout needs
it:

* ``all_gather``: blocks of a dim from every rank (the eps over ``data``
  and ``seq``, K/V frames when a motion module's tokens do not split, the
  decoded frames);
* ``all_to_all``: one dim's blocks traded for another's (frame shards to
  token shards at a motion module's entry, and back at its exit);
* ``all_reduce``: SUM (the row-parallel ``to_out`` over ``tensor``, the
  motion GroupNorm's sums over ``seq``) and MAX (the int8 activation scale
  over the evaluation's shards);
* ``broadcast``: the first frame from the ``seq`` rank that holds it.

A group of ``None`` (one rank) issues no call.  Each call adds one to
``calls`` (a CUDA graph's replays add what its capture recorded,
``ops.launches``) and, inside ``recording()``, appends a
``CollectiveOp``: its kind (named as in HLO, as the JAX audit names them),
dtype, output shape, group size and output bytes, and its group, so that
``parallel.audit.time_collectives`` can issue it again alone and time it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

calls = 0
# the one-tensor all-gather (renamed in newer PyTorch)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_RECORDS: Optional[List["CollectiveOp"]] = None


@dataclass
class CollectiveOp:
    kind: str  # "all-gather", "all-to-all", "all-reduce", "collective-broadcast"
    dtype: str
    shape: tuple  # of the output
    group_size: int
    out_bytes: int
    group: object = None
    ms: Optional[float] = None  # one call's device ms, issued alone (audit.time_collectives)

    def wire_bytes_per_device(self) -> int:
        """Bytes each rank moves under the ring algorithms (the JAX audit's
        model, ``parallel/audit.py``)."""
        from i2v_adapter_tpu_torch.parallel.audit import wire_bytes

        return wire_bytes(self.kind, self.out_bytes, self.group_size)


@contextlib.contextmanager
def recording():
    """Collect a ``CollectiveOp`` per call made inside (the calls of a CUDA
    graph's replay are not seen)."""
    global _RECORDS
    outer = _RECORDS
    ops: List[CollectiveOp] = []
    _RECORDS = ops
    try:
        yield ops
    finally:
        _RECORDS = outer


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _issue(kind: str, out: torch.Tensor, group, call) -> None:
    global calls
    call()
    calls += 1
    if _RECORDS is not None:
        _RECORDS.append(CollectiveOp(kind, str(out.dtype).replace("torch.", ""), tuple(out.shape),
                                     _size(group), out.numel() * out.element_size(), group))


def reissue(op: CollectiveOp, device: torch.device):
    """A call that issues ``op``'s collective again on fresh buffers of its
    shapes (SUM for an all-reduce, from group rank 0 for a broadcast),
    unrecorded: what ``parallel.audit.time_collectives`` times."""
    out = torch.zeros(op.shape, dtype=getattr(torch, op.dtype), device=device)
    group = op.group
    if op.kind == "all-gather":
        inp = out[: out.shape[0] // op.group_size].clone()
        return lambda: _all_gather_single(out, inp, group=group)
    if op.kind == "all-to-all":
        inp = torch.zeros_like(out)
        return lambda: dist.all_to_all_single(out, inp, group=group)
    if op.kind == "all-reduce":
        return lambda: dist.all_reduce(out, group=group)
    return lambda: dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in group-rank order."""
    n = _size(group)
    if n == 1:
        return x
    inp = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * inp.shape[0],) + tuple(inp.shape[1:]), dtype=x.dtype, device=x.device)
    _issue("all-gather", out, group, lambda: _all_gather_single(out, inp, group=group))
    return out.movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """Split ``x`` in group-size blocks along ``split_dim``, send block ``j``
    to group rank ``j``, and concatenate the blocks received along
    ``concat_dim`` in group-rank order."""
    n = _size(group)
    if n == 1:
        return x
    inp = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    _issue("all-to-all", out, group, lambda: dist.all_to_all_single(out, inp, group=group))
    return torch.cat(out.unbind(0), dim=concat_dim)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """Reduce ``x`` over the group (``op``: ``"sum"`` or ``"max"``); the
    result on every rank.  Writes in place when ``x`` is contiguous."""
    if _size(group) == 1:
        return x
    out = x.contiguous()
    _issue("all-reduce", out, group, lambda: dist.all_reduce(out, op=_OPS[op], group=group))
    return out


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank (each passes a tensor of the
    same shape and dtype; the others' values are not read)."""
    if _size(group) == 1:
        return x
    out = x.contiguous().clone()
    _issue("collective-broadcast", out, group,
           lambda: dist.broadcast(out, src=dist.get_global_rank(group, src), group=group))
    return out
