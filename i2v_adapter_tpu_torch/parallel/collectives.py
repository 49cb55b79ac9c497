"""The collectives of serving and training over a mesh, with their adjoints.

In the JAX package these are inserted by GSPMD (and by ``shard_map``'s
explicit ``all_gather``), which also derives their transposes for the
backward pass; the port states each one where its layout needs it, and each
one that can carry a gradient is a ``torch.autograd.Function`` whose
backward is the adjoint collective:

==============================================  ==============================================
forward                                         adjoint (backward)
==============================================  ==============================================
``all_gather`` (blocks of a dim from every      ``reduce-scatter`` (SUM): each rank gets the
rank: K/V frames over ``seq``, the eps, a       sum of the gradients of its block
ZeRO shard of a parameter over ``fsdp``)
``all_to_all`` (frame shards to token shards    the inverse all-to-all
at a motion module's entry, and back)
``all_reduce(op="sum")`` over an axis the data  SUM all-reduce of the gradients
is split over (the motion GroupNorm's sums
over ``seq``)
``broadcast`` from ``src`` (the first frame     SUM-reduce to ``src``, zero on the other ranks
over ``seq``)
``reduce_from_parallel``: SUM all-reduce over   identity (Megatron's ``g``: the row-parallel
an axis the data is replicated over             ``to_out``)
(``tensor``)
``copy_to_parallel``: identity                  SUM all-reduce (Megatron's ``f``: the input of
                                                the column-parallel q/k/v)
``all_reduce(op="max")`` (the int8 activation   none: forward only, raises if asked for a
scale, serving only)                            gradient
==============================================  ==============================================

Without a gradient to carry (serving under ``torch.no_grad``, or a tensor
that does not require one) a Function runs its forward alone: serving
issues the forward calls only.  No call writes into its input.  A group
of ``None`` (one rank) issues no call.  Each call, forward or
backward, adds one to ``calls`` (a CUDA graph's replays add what its
capture recorded, ``ops.launches``) and, inside ``recording()``, appends a
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
# the one-tensor all-gather and reduce-scatter (renamed in newer PyTorch)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_RECORDS: Optional[List["CollectiveOp"]] = None

ALL_GATHER, ALL_TO_ALL, ALL_REDUCE, BROADCAST = "all-gather", "all-to-all", "all-reduce", "collective-broadcast"
REDUCE_SCATTER, REDUCE = "reduce-scatter", "reduce"


@dataclass
class CollectiveOp:
    kind: str  # ALL_GATHER, ALL_TO_ALL, ALL_REDUCE, BROADCAST, REDUCE_SCATTER or REDUCE
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
    """Collect a ``CollectiveOp`` per call made inside, backward calls
    included (the calls of a CUDA graph's replay are not seen)."""
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
    shapes (SUM for a reduction, from or to group rank 0 for a broadcast or
    a reduce), unrecorded: what ``parallel.audit.time_collectives`` times."""
    out = torch.zeros(op.shape, dtype=getattr(torch, op.dtype), device=device)
    group = op.group
    if op.kind == ALL_GATHER:
        inp = out[: out.shape[0] // op.group_size].clone()
        return lambda: _all_gather_single(out, inp, group=group)
    if op.kind == REDUCE_SCATTER:
        inp = torch.zeros((out.shape[0] * op.group_size,) + tuple(out.shape[1:]), dtype=out.dtype, device=device)
        return lambda: _reduce_scatter_single(out, inp, group=group)
    if op.kind == ALL_TO_ALL:
        inp = torch.zeros_like(out)
        return lambda: dist.all_to_all_single(out, inp, group=group)
    if op.kind == ALL_REDUCE:
        return lambda: dist.all_reduce(out, group=group)
    if op.kind == REDUCE:
        return lambda: dist.reduce(out, dst=dist.get_global_rank(group, 0), group=group)
    return lambda: dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)


# ---------------------------------------------------------------------------
# the collectives themselves (the Functions' forwards and backwards)
# ---------------------------------------------------------------------------


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    inp = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * inp.shape[0],) + tuple(inp.shape[1:]), dtype=x.dtype, device=x.device)
    _issue(ALL_GATHER, out, group, lambda: _all_gather_single(out, inp, group=group))
    return out.movedim(0, dim).contiguous()


def _scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    inp = x.movedim(dim, 0).contiguous()
    out = torch.empty((inp.shape[0] // n,) + tuple(inp.shape[1:]), dtype=x.dtype, device=x.device)
    _issue(REDUCE_SCATTER, out, group, lambda: _reduce_scatter_single(out, inp, group=group))
    return out.movedim(0, dim).contiguous()


def _trade(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    n = _size(group)
    inp = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    _issue(ALL_TO_ALL, out, group, lambda: dist.all_to_all_single(out, inp, group=group))
    return torch.cat(out.unbind(0), dim=concat_dim)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _reduce_all(x: torch.Tensor, op: str, group) -> torch.Tensor:
    out = x.contiguous()
    if out.data_ptr() == x.data_ptr():
        out = out.clone()
    _issue(ALL_REDUCE, out, group, lambda: dist.all_reduce(out, op=_OPS[op], group=group))
    return out


def _send(x: torch.Tensor, src: int, group) -> torch.Tensor:
    out = x.contiguous().clone()
    _issue(BROADCAST, out, group, lambda: dist.broadcast(out, src=dist.get_global_rank(group, src), group=group))
    return out


def _reduce_to(x: torch.Tensor, dst: int, group) -> torch.Tensor:
    out = x.contiguous().clone()
    _issue(REDUCE, out, group, lambda: dist.reduce(out, dst=dist.get_global_rank(group, dst), group=group))
    if dist.get_rank(group) != dst:
        out.zero_()  # the reduction's partial sums stay on the other ranks' buffers
    return out


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _trade(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _trade(g, concat_dim, split_dim, ctx.group), None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_all(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_all(g, "sum", ctx.group), None


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce_all(x, "max", group)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("the MAX all-reduce carries no gradient (the int8 activation scale is serving's)")


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        return _send(x, src, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_to(g, ctx.src, ctx.group), None, None


class _ReduceFromParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce_all(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_all(g, "sum", ctx.group), None


# ---------------------------------------------------------------------------
# the calls the sites make
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in group-rank order.
    Adjoint: the reduce-scatter (SUM) of the gradient along ``dim``."""
    return x if _size(group) == 1 else _AllGather.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """Split ``x`` in group-size blocks along ``split_dim``, send block ``j``
    to group rank ``j``, and concatenate the blocks received along
    ``concat_dim`` in group-rank order.  Adjoint: the inverse trade."""
    return x if _size(group) == 1 else _AllToAll.apply(x, split_dim, concat_dim, group)


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """Reduce ``x`` over the group (``op``: ``"sum"`` or ``"max"``); the
    result on every rank, in a new tensor.  SUM is the reduction over an
    axis the data is split over (adjoint: the SUM all-reduce of the
    gradient); MAX carries no gradient."""
    if _size(group) == 1:
        return x
    return (_AllReduceSum if op == "sum" else _AllReduceMax).apply(x, group)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank (each passes a tensor of the
    same shape and dtype; the others' values are not read).  Adjoint: the
    gradients SUM-reduced to ``src``, zero on the other ranks."""
    return x if _size(group) == 1 else _Broadcast.apply(x, src, group)


def reduce_from_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """SUM all-reduce of partial results over an axis the data is replicated
    over (the row-parallel ``to_out`` over ``tensor``); the gradient passes
    through unchanged, as every rank already holds the whole of it."""
    return x if _size(group) == 1 else _ReduceFromParallel.apply(x, group)


def copy_to_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Identity on an input replicated over ``group`` that feeds sliced
    (column-parallel) projections; its gradient, a partial sum on each
    rank, is SUM all-reduced."""
    return x if _size(group) == 1 else _CopyToParallel.apply(x, group)
