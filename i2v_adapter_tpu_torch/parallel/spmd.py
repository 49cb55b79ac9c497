"""The UNet's sites over the serving mesh (the JAX package's
``parallel/spmd.py``).

In the JAX package GSPMD partitions the sampler and ``shard_map`` runs the
Pallas sites on their local shards.  In the port every rank runs the UNet on
its own slab of one evaluation, and the modules consult the active
``AttentionSpmd`` where a site couples what the slab splits:

* the evaluation's dim 0 is the CFG-doubled batch, clip-major and
  frame-minor: its clips split over ``data`` (``clip_split``) and each
  clip's frames over ``seq`` (``frame_split``), each only where it divides
  (the pipeline decides per evaluation, as the JAX ``shard_evals`` does);
* spatial attention, the resnets and their convs (K4 included) are
  frame-local: the kernels run on the slab as it is, with the weights
  replicated, so they need no wrapper here;
* the cross-frame adapter's K/V come from each clip's first frame,
  broadcast from the ``seq`` rank that holds frame 0
  (``first_frame_constraint``), and K1 runs with the local ``kv_repeat``
  (``spmd_flash_attention``);
* a motion module normalises over all of a clip's frames (its GroupNorm's
  sums all-reduced over ``seq``, ``motion_group_norm``) and then runs
  token-sharded where the tokens divide (``temporal_token_constraint``:
  one all-to-all in, ``temporal_frame_constraint`` one out; every frame is
  local and the frame attention needs no collective), else frame-sharded
  with K/V gathered over ``seq`` (``spmd_temporal_attention``);
* under ``tensor`` the attention projections are sliced in place
  (``shard_tensor_parallel``, from ``tp_param_shardings``' rules): q/k/v
  by column, so each rank runs its heads, and ``to_out`` by row, its
  partial sums all-reduced over ``tensor`` before the bias
  (``row_parallel_out``);
* an int8 conv's per-tensor activation scale is all-reduced (MAX) over the
  evaluation's shards (``shared_activation_scale``), so each rank quantises
  with the scale of the whole tensor, as one card does.

The JAX package drops to XLA attention where its ``shard_map`` layouts do
not fit (several clips per shard with frames split); the port's slabs are
clip-major with whole clips' frame blocks, so its local ``kv_repeat`` always
fits and the kernels always run on the slab.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from i2v_adapter_tpu_torch.parallel import collectives
from i2v_adapter_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, TENSOR_AXIS, Mesh

# ---------------------------------------------------------------------------
# the context: how one evaluation is laid out over the mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionSpmd:
    """The layout of the evaluation running inside: which of dim 0's clips
    and frames this rank holds, the evaluation's global frame count and,
    inside a motion module, whether its tokens or its frames are split."""

    mesh: Mesh
    clip_split: bool = True  # clips over ``data``
    frame_split: bool = True  # frames over ``seq``
    frames: int = 1  # the evaluation's frames per clip, all ranks together
    layout: str = "frames"  # inside a motion module: "frames" or "tokens"

    @property
    def eval_axes(self) -> Tuple[str, ...]:
        """The axes dim 0 is split over (those of size 1 left out)."""
        axes = ((DATA_AXIS,) if self.clip_split else ()) + ((SEQ_AXIS,) if self.frame_split else ())
        return tuple(a for a in axes if self.mesh.size(a) > 1)

    @property
    def seq_size(self) -> int:
        return self.mesh.size(SEQ_AXIS) if self.frame_split else 1

    @property
    def seq_group(self):
        return self.mesh.group(SEQ_AXIS) if self.frame_split else None

    @property
    def local_frames(self) -> int:
        return self.frames // self.seq_size

    @property
    def frame_offset(self) -> int:
        return self.mesh.index(SEQ_AXIS) * self.local_frames if self.frame_split else 0


_STACK: list = []


@contextlib.contextmanager
def attention_spmd(mesh: Mesh, **kwargs):
    """Run the UNet (or the decoder) inside as one rank's slab of an
    evaluation laid out over ``mesh`` (``AttentionSpmd``'s fields)."""
    ctx = AttentionSpmd(mesh, **kwargs)
    _STACK.append(ctx)
    try:
        yield ctx
    finally:
        _STACK.pop()


@contextlib.contextmanager
def _nested(ctx: AttentionSpmd, **changes):
    _STACK.append(dataclasses.replace(ctx, **changes))
    try:
        yield _STACK[-1]
    finally:
        _STACK.pop()


def current_attention_spmd() -> Optional[AttentionSpmd]:
    return _STACK[-1] if _STACK else None


# ---------------------------------------------------------------------------
# the sites
# ---------------------------------------------------------------------------


def spmd_flash_attention(call, q, k, v, kv_repeat: int, ctx: AttentionSpmd):
    """K1 on this rank's slab: ``call(q, k, v, local_repeat)``.  ``kv_repeat``
    is the global count (the clip's frames at the cross-frame site, else 1).

    The JAX package's three layouts are one rule here: with ``kv_repeat ==
    1`` dim 0 splits over clips x frames and the kernel runs as it is; at the
    cross-frame site K/V hold one first frame per local clip (broadcast over
    ``seq``), and q the local clips' local frames, clip-major, so the local
    repeat is ``kv_repeat / seq`` whether the slab holds one clip or several
    (the kernel routes q row ``b`` to K/V row ``b // local_repeat``)."""
    s = ctx.seq_size
    if kv_repeat == 1:
        return call(q, k, v, 1)
    if kv_repeat % s:
        raise ValueError(f"kv_repeat {kv_repeat} does not split over {s} seq ranks")
    return call(q, k, v, kv_repeat // s)


def spmd_temporal_attention(call, q, k, v, heads: int, ctx: AttentionSpmd):
    """K2 on this rank's ``(B, F, S, C)`` operands: ``call(q, k, v, heads)``
    with ``heads`` this rank's.  Token-sharded (every frame local) it runs
    as it is; frame-sharded, K/V are gathered over ``seq`` and the local
    queries attend over all frames."""
    if ctx.layout == "frames" and ctx.seq_size > 1:
        k = collectives.all_gather(k, 1, ctx.seq_group)
        v = collectives.all_gather(v, 1, ctx.seq_group)
    return call(q, k, v, heads)


def motion_tokens_split(ctx: Optional[AttentionSpmd], tokens: int) -> bool:
    """Whether a motion module with ``tokens`` spatial tokens runs
    token-sharded: its frames are split and its tokens divide."""
    return ctx is not None and ctx.seq_size > 1 and tokens % ctx.seq_size == 0


def temporal_token_constraint(x: torch.Tensor) -> torch.Tensor:
    """``(B, F/seq, S, C)`` frame-sharded -> ``(B, F, S/seq, C)``
    token-sharded: one all-to-all over ``seq``."""
    ctx = current_attention_spmd()
    return collectives.all_to_all(x, 2, 1, ctx.seq_group)


def temporal_frame_constraint(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``temporal_token_constraint`` at the module's exit."""
    ctx = current_attention_spmd()
    return collectives.all_to_all(x, 1, 2, ctx.seq_group)


def motion_layout(ctx: AttentionSpmd, tokens_split: bool):
    """The context inside a motion module's blocks."""
    return _nested(ctx, layout="tokens" if tokens_split else "frames")


def first_frame_constraint(x: torch.Tensor) -> torch.Tensor:
    """Each local clip's first frame ``(B, S, C)``, taken by the ranks of
    ``seq`` index 0 from their slab: broadcast over ``seq``."""
    ctx = current_attention_spmd()
    if ctx is None:
        return x
    return collectives.broadcast(x, 0, ctx.seq_group)


def motion_group_norm(x: torch.Tensor, num_groups: int, eps: float, weight, bias) -> torch.Tensor:
    """GroupNorm of ``x (B, N, C)`` per clip over all N positions of every
    rank of ``seq`` (N is this rank's frames x tokens): the sums and then
    the squared deviations all-reduced over ``seq``, in fp32."""
    ctx = current_attention_spmd()
    group = None if ctx is None else ctx.seq_group
    b, n, c = x.shape
    xf = x.reshape(b, n, num_groups, c // num_groups).float()
    count = n * (c // num_groups) * (1 if ctx is None else ctx.seq_size)
    mean = collectives.all_reduce(xf.sum(dim=(1, 3), keepdim=True), "sum", group) / count
    var = collectives.all_reduce(((xf - mean) ** 2).sum(dim=(1, 3), keepdim=True), "sum", group) / count
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, n, c)
    return (y * weight.float() + bias.float()).to(x.dtype)


def shared_activation_scale(xs: torch.Tensor) -> torch.Tensor:
    """An int8 site's activation scale (a 0-d tensor) as the whole
    evaluation's: the MAX over the ranks its dim 0 is split over (the
    division by 127 and the clamp keep the order of the maxima, so this is
    the scale of the whole tensor bit for bit)."""
    ctx = current_attention_spmd()
    if ctx is None or not ctx.eval_axes:
        return xs
    return collectives.all_reduce(xs.reshape(1).clone(), "max", ctx.mesh.group(ctx.eval_axes)).reshape(())


def row_parallel_out(linear: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """``linear(x)`` for a ``to_out`` whose input features are split over
    ``tensor``: the partial product all-reduced (SUM), then the bias once."""
    if group is None:
        return linear(x)
    y = collectives.all_reduce(F.linear(x, linear.weight.to(x.dtype)), "sum", group)
    return y if linear.bias is None else y + linear.bias.to(y.dtype)


# ---------------------------------------------------------------------------
# tensor-parallel parameter rules
# ---------------------------------------------------------------------------

# column-sharded projections (output features over tensor)
_COL_KEYS = ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip")
# row-sharded projections (input features over tensor; the partial outputs
# all-reduced)
_ROW_KEYS = ("to_out",)


def _tp_spec(path: Tuple[str, ...], shape, tsize: int, heads: int) -> Tuple[Optional[str], ...]:
    """The JAX ``_tp_spec`` on a Flax-layout leaf (``kernel (in, out)``), as
    a tuple (``()`` replicated): q/k/v column-parallel, ``to_out``
    row-parallel, biases of row-parallel layers replicated (added once after
    the all-reduce), the GEGLU feed-forward not sharded."""
    if tsize <= 1 or len(shape) == 0:
        return ()
    names = [str(p) for p in path]
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if parent in _COL_KEYS and leaf == "kernel" and shape[-1] % tsize == 0:
        return (None,) * (len(shape) - 1) + (TENSOR_AXIS,)
    if parent in _COL_KEYS and leaf == "bias" and shape[0] % tsize == 0:
        return (TENSOR_AXIS,)
    if parent in _ROW_KEYS and leaf == "kernel" and shape[0] % tsize == 0:
        return (TENSOR_AXIS,) + (None,) * (len(shape) - 1)
    return ()


def tp_param_shardings(module: nn.Module, tsize: int, heads: int = 8) -> Dict[str, Tuple]:
    """``_tp_spec`` of every parameter of a UNet, keyed by its dotted name,
    the spec in the Flax layout of the JAX package's tree
    (``utils.convert.flax_leaf``)."""
    from i2v_adapter_tpu_torch.utils.convert import flax_leaf

    modules = dict(module.named_modules())
    out = {}
    for name, p in module.named_parameters():
        path, perm = flax_leaf(modules, name)
        shape = tuple(p.shape[i] for i in perm) if perm is not None else tuple(p.shape)
        out[name] = _tp_spec(tuple(path), shape, tsize, heads)
    return out


def pipeline_param_shardings(modules: Dict[str, nn.Module], tsize: int, heads: int = 8) -> Dict[str, Dict]:
    """The UNet's parameters under the tensor-parallel rules; the VAE and
    the CLIP towers stay whole (every spec ``()``)."""
    return {name: tp_param_shardings(m, tsize, heads) if name == "unet"
            else {p: () for p, _ in m.named_parameters()}
            for name, m in modules.items() if m is not None}


def _attention_modules(unet: nn.Module):
    from i2v_adapter_tpu_torch.models.attention import Attention
    from i2v_adapter_tpu_torch.models.temporal import TemporalSelfAttention

    return [(n, m) for n, m in unet.named_modules() if isinstance(m, (Attention, TemporalSelfAttention))]


def shard_tensor_parallel(unet: nn.Module, mesh: Mesh) -> int:
    """Slice the UNet's attention projections in place to this rank's
    ``tensor`` block by ``tp_param_shardings``' specs: column-sharded
    projections keep their block of output rows, ``to_out`` its block of
    input columns and an all-reduce over ``tensor``; the module's head count
    drops to its share.  A module whose heads do not divide stays whole.
    The whole parameters are kept for ``unshard_tensor_parallel``.  Returns
    the number of modules sliced."""
    t = mesh.size(TENSOR_AXIS)
    if t == 1:
        return 0
    from i2v_adapter_tpu_torch.utils.convert import flax_leaf

    idx, group = mesh.index(TENSOR_AXIS), mesh.group(TENSOR_AXIS)
    specs = tp_param_shardings(unet, t)
    modules = dict(unet.named_modules())
    sliced = 0
    for name, m in _attention_modules(unet):
        if m.heads % t:
            continue
        full = {}
        for proj in _COL_KEYS + _ROW_KEYS:
            linear = getattr(m, proj, None)
            if linear is None:
                continue
            for leaf in ("weight", "bias"):
                p = getattr(linear, leaf)
                key = f"{name}.{proj}.{leaf}"
                if p is None or TENSOR_AXIS not in specs[key]:
                    continue
                _, perm = flax_leaf(modules, key)
                flax_dim = specs[key].index(TENSOR_AXIS)
                dim = perm[flax_dim] if perm is not None else flax_dim
                per = p.shape[dim] // t
                full[(proj, leaf)] = p
                setattr(linear, leaf, nn.Parameter(p.detach().narrow(dim, idx * per, per).contiguous(),
                                                   requires_grad=False))
        m._tp_full = full
        m.heads //= t
        m.tp_group = group
        sliced += 1
    return sliced


def unshard_tensor_parallel(unet: nn.Module) -> None:
    """Put back the whole parameters ``shard_tensor_parallel`` kept."""
    for _, m in _attention_modules(unet):
        full = m.__dict__.pop("_tp_full", None)
        if full is None:
            continue
        for (proj, leaf), p in full.items():
            setattr(getattr(m, proj), leaf, p)
        m.heads = getattr(m, "to_q").weight.shape[0] // m.dim_head
        m.tp_group = None
