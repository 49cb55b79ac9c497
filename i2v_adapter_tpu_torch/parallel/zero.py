"""The ZeRO placement of a train state over a mesh's ``fsdp`` axis, and the
slicing of its attention projections over ``tensor``.

The JAX package places the state with ``jax.device_put(state,
train_state_shardings(...))`` and GSPMD gathers each sharded weight where
the step uses it and reduce-scatters its gradient.  The port does both
itself, through ``parallel.collectives`` (so ``recording()`` sees them):

* at rest each rank holds its block of every tensor that
  ``parallel.mesh.train_state_shardings`` shards over ``fsdp`` (trainables
  and their optimizer moments, accumulator and EMA; under
  ``fsdp_frozen='shard'`` the frozen UNet and the towers): the parameter
  slot itself holds the block, so ``named_parameters()`` and the optimizer
  see blocks;
* each top-level block of the UNet (the time tower, ``conv_in``, each
  Down / Mid / Up block, the output head) gathers its sharded weights just
  before it runs forward, and again in its activation-checkpointing
  recompute (forward pre-hooks; the gathered weight shadows the slot until
  the block returns).  The weights are gathered flat, one
  ``collectives.all_gather`` per (axis, dtype, trainable or frozen) group
  of the block's weights (a call per weight costs a host call and a
  latency-bound launch each); the gather's adjoint reduce-scatters the
  trainable group's gradient onto its blocks;
* a frozen tower is gathered whole around its use in the step's
  conditioning (no gradient flows there), flat in the same way;
* ``sum_gradients`` sums the trainables' gradients over the rest of the
  ranks that hold them: a reduce-scattered block over ``data`` x ``seq``,
  a replicated leaf over ``data`` x ``fsdp`` x ``seq`` (with ``fsdp`` 1 a
  plain all-reduce over ``data`` x ``seq``), each group's leaves in one
  flat call;
* ``global_sq_norm`` is the squared norm of the whole gradient: the
  blocks' squared sums all-reduced over ``fsdp``, the replicated leaves'
  added once.

Under ``tensor`` the specs split the attention projections (the Megatron
rules of ``parallel.spmd._tp_spec``, trainables included): those blocks
are not gathered; their modules run their share of the heads
(``column_parallel_in`` / ``row_parallel_out``), their gradients are
whole for the block on each rank and are summed over ``data`` x ``fsdp``
x ``seq`` like a replicated leaf's, and their squared sums are all-reduced
over ``tensor`` for the norm.  A tower's ``tensor``-split weights are
gathered around its use like its ``fsdp`` ones.

Every rank makes every call here in the same order (the state's entries in
``training.checkpoint.state_entries`` order).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from i2v_adapter_tpu_torch.parallel import collectives
from i2v_adapter_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    GRAD_AXES,
    SEQ_AXIS,
    TENSOR_AXIS,
    Mesh,
    spec_dim,
)


class Zero:
    """A placed state's record: which dim of which tensor is split over
    which axis (``fsdp``, or ``tensor`` for the attention projections) and
    its whole shape; the forward hooks that gather the UNet's blocks; the
    gradient sums."""

    def __init__(self, mesh: Mesh, specs: Dict[str, tuple]):
        self.mesh = mesh
        self.specs = dict(specs)
        self.dims: Dict[str, int] = {}  # state name -> the sharded dim, PyTorch layout
        self.axes: Dict[str, str] = {}  # state name -> the axis it is split over
        # (field, param name) -> (sharded Flax dim, axis)
        self.flax_dims: Dict[Tuple[str, str], Tuple[int, str]] = {}
        self.grad_axis: Dict[str, Optional[str]] = {}  # trainable name -> the axis its gradient is split over
        self.active = True  # False while ``materialized``: the slots hold whole tensors
        self.sliced: List[nn.Module] = []  # attention modules running their ``tensor`` heads
        self.unit_gathers: Dict[str, list] = {}  # UNet child -> its flat gathers' groups

    # -- placement ---------------------------------------------------------

    @staticmethod
    def spec_axis(spec: tuple) -> Tuple[Optional[int], Optional[str]]:
        """(Flax dim, axis) a spec splits, (None, None) when replicated."""
        for axis in (FSDP_AXIS, TENSOR_AXIS):
            d = spec_dim(spec, axis)
            if d is not None:
                return d, axis
        return None, None

    def place(self, state) -> None:
        """Replace each tensor the specs split by this rank's block (a new
        ``nn.Parameter`` for a parameter, keeping ``requires_grad``); the
        attention modules whose projections are split over ``tensor`` run
        their share of the heads over the ``tensor`` group."""
        from i2v_adapter_tpu_torch.training.checkpoint import state_entries

        sliced = set()
        for name, slots, key, perm, param in state_entries(state):
            field = "/".join(name.split("/")[:2 if name.startswith("opt_state/") else 1])
            d, axis = self.spec_axis(self.specs.get(name, ()))
            if field == "trainable":
                self.grad_axis[param] = axis
            if d is None:
                continue
            self.flax_dims[(field, param)] = (d, axis)
            dim = perm[d] if perm is not None else d
            t = slots[key]
            if t.shape[dim] % self.mesh.size(axis):
                raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not split over {axis} "
                                 f"{self.mesh.size(axis)}")
            self.dims[name], self.axes[name] = dim, axis
            block = self.block(t.detach(), dim, axis).clone()
            slots[key] = nn.Parameter(block, requires_grad=t.requires_grad) if isinstance(t, nn.Parameter) else block
            if axis == TENSOR_AXIS and field in ("trainable", "frozen"):
                sliced.add(param.rpartition(".")[0].rpartition(".")[0])  # the attention module
        t = self.mesh.size(TENSOR_AXIS)
        for name, m in state.unet.named_modules():
            if name in sliced:
                if m.heads % t:
                    raise ValueError(f"{name}: {m.heads} heads do not split over tensor {t}")
                m.heads //= t
                m.tp_group = self.mesh.group(TENSOR_AXIS)
                self.sliced.append(m)

    def block(self, t: torch.Tensor, dim: int, axis: str = FSDP_AXIS) -> torch.Tensor:
        """This rank's block of a whole tensor along ``dim`` over ``axis``."""
        per = t.shape[dim] // self.mesh.size(axis)
        return t.narrow(dim, self.mesh.index(axis) * per, per)

    def full_flax_shape(self, name: str, t: torch.Tensor) -> tuple:
        """The whole Flax-layout shape of the state tensor ``name`` whose
        live (Flax-layout view of the) block is ``t``."""
        if name not in self.dims:
            return tuple(t.shape)
        d, axis = self.spec_axis(self.specs[name])
        shape = list(t.shape)
        shape[d] *= self.mesh.size(axis)
        return tuple(shape)

    def _sharded_params(self, module: nn.Module) -> List[list]:
        """The parameters under ``module`` gathered around its use (split
        over ``fsdp``; in a tower, also over ``tensor``), as ``(owner,
        attr, dim, axis)``, grouped by what one flat gather can carry: the
        axis, the dtype and whether the parameter trains."""
        groups: Dict[tuple, list] = {}
        for owner in module.modules():
            for attr, (dim, axis) in (owner.__dict__.get("_zero_dims") or {}).items():
                p = owner._parameters[attr]
                groups.setdefault((axis, p.dtype, p.requires_grad), []).append((owner, attr, dim, axis))
        return list(groups.values())

    def _gather_flat(self, groups: List[list]) -> None:
        """Gather each group's blocks in one all-gather of their flattened
        concatenation and set each whole weight on its owner (shadowing the
        slot); the gradients reach the blocks through the gather's
        adjoint."""
        for group in groups:
            axis = group[0][3]
            n = self.mesh.size(axis)
            blocks = [owner._parameters[attr] for owner, attr, _, _ in group]
            flat = torch.cat([b.reshape(-1) for b in blocks])
            whole = collectives.all_gather(flat, 0, self.mesh.group(axis)).view(n, -1)
            at = 0
            for (owner, attr, dim, _), b in zip(group, blocks):
                shape = list(b.shape)
                part = whole[:, at:at + b.numel()].reshape([n] + shape)  # rank-major blocks
                shape[dim] *= n
                owner.__dict__[attr] = part.movedim(0, dim).reshape(shape)
                at += b.numel()

    def mark(self, state) -> None:
        """Note on each owning module which of its parameters are gathered
        around their use (``_zero_dims``: the UNet's split over ``fsdp``,
        the towers' split over either axis), and hook the UNet's top-level
        blocks."""
        from i2v_adapter_tpu_torch.training.checkpoint import state_entries

        owners = {}
        for module in [state.unet] + [getattr(state, t) for t in ("vae", "text_encoder", "image_encoder")]:
            if module is not None:
                tower = module is not state.unet
                owners.update({id(m._parameters): (m, tower) for m in module.modules()})
        for name, slots, key, _, _ in state_entries(state):
            if name in self.dims and id(slots) in owners:
                owner, tower = owners[id(slots)]
                if tower or self.axes[name] == FSDP_AXIS:
                    owner.__dict__.setdefault("_zero_dims", {})[key] = (self.dims[name], self.axes[name])
        if state.unet.__dict__.get("_zero_dims"):
            raise ValueError("the UNet's own parameters cannot be sharded (only its blocks' are gathered)")
        for name, child in state.unet.named_children():
            groups = self._sharded_params(child)
            self.unit_gathers[name] = groups
            if groups:
                child.register_forward_pre_hook(self._gather_hook(groups))
                child.register_forward_hook(self._release_hook(groups))

    def counts(self, state) -> Dict[str, int]:
        """The ZeRO collectives of one train step, by where they come from:
        ``unit_gathers`` (one flat all-gather per group of a UNet block's
        sharded weights per forward of the block), ``block_gathers`` (those
        of the Down / Mid / Up blocks, gathered again in their
        activation-checkpointing recompute), ``tower_gathers`` (the
        towers' groups, gathered around the conditioning),
        ``reduce_scatters`` (one per trainable group: its gather's
        adjoint); and the trainables: ``fsdp_trainables`` and
        ``tensor_trainables`` (those split over each axis) of
        ``trainables``."""
        blocks = sum(len(g) for name, g in self.unit_gathers.items()
                     if name.startswith(("down_blocks_", "up_blocks_")) or name == "mid_block")
        towers = [state.vae, state.text_encoder] + ([state.image_encoder] if state.unet.config.use_ip_adapter else [])
        axes = list(self.grad_axis.values())
        return {"unit_gathers": sum(len(g) for g in self.unit_gathers.values()), "block_gathers": blocks,
                "tower_gathers": sum(len(self._sharded_params(t)) for t in towers if t is not None),
                "reduce_scatters": sum(1 for groups in self.unit_gathers.values() for g in groups if _trains(g)),
                "fsdp_trainables": axes.count(FSDP_AXIS), "tensor_trainables": axes.count(TENSOR_AXIS),
                "trainables": len(axes)}

    def _gather_hook(self, groups):
        def hook(module, args):
            if self.active:
                self._gather_flat(groups)
        return hook

    @staticmethod
    def _release_hook(groups):
        def hook(module, args, output):
            for group in groups:
                for owner, attr, _, _ in group:
                    owner.__dict__.pop(attr, None)
        return hook

    @contextlib.contextmanager
    def unsharded(self, module: Optional[nn.Module]):
        """``module``'s sharded weights gathered (no gradient) while inside."""
        groups = [] if module is None or not self.active else self._sharded_params(module)
        try:
            with torch.no_grad():
                self._gather_flat(groups)
            yield module
        finally:
            for group in groups:
                for owner, attr, _, _ in group:
                    owner.__dict__.pop(attr, None)

    # -- whole tensors -----------------------------------------------------

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole of state tensor ``name`` from its block ``t`` (PyTorch
        layout); ``t`` itself when it is not sharded."""
        if name not in self.dims:
            return t
        with torch.no_grad():
            return collectives.all_gather(t.detach(), self.dims[name], self.mesh.group(self.axes[name]))

    def full_tensors(self, state) -> Dict[str, torch.Tensor]:
        """Every state tensor whole, in the Flax layout, under its name (what
        ``train_state_tensors`` gives for an unplaced state).  Every rank
        calls it."""
        from i2v_adapter_tpu_torch.training.checkpoint import state_entries

        out = {}
        for name, slots, key, perm, _ in state_entries(state):
            t = self.gather(name, slots[key].detach())
            out[name] = t.permute(perm) if perm is not None else t
        return out

    @contextlib.contextmanager
    def materialized(self, state):
        """The whole state in place while inside (every parameter's data and
        the optimizer's and EMA's tensors), blocks again after: for code
        that reads the modules as one card holds them (adapter
        checkpoints, the pipeline export, validation).  Every rank enters."""
        from i2v_adapter_tpu_torch.training.checkpoint import state_entries

        fulls = [(slots, key, self.gather(name, slots[key])) for name, slots, key, _, _ in state_entries(state)
                 if name in self.dims]
        kept = []
        self.active = False
        heads = [(m, m.heads, m.tp_group) for m in self.sliced]
        try:
            for m, _, _ in heads:
                m.heads, m.tp_group = m.heads * self.mesh.size(TENSOR_AXIS), None
            for slots, key, full in fulls:
                t = slots[key]
                if isinstance(t, nn.Parameter):
                    kept.append((t, None, None, t.data))
                    t.data = full
                else:
                    kept.append((None, slots, key, t))
                    slots[key] = full
            yield state
        finally:
            for p, slots, key, old in reversed(kept):
                if p is not None:
                    p.data = old
                else:
                    slots[key] = old
            for m, h, group in heads:
                m.heads, m.tp_group = h, group
            self.active = True

    # -- gradients ---------------------------------------------------------

    def sum_gradients(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The trainables' gradients summed over every rank that holds the
        same block, never over ``tensor`` (whose ranks compute the same
        replicated loss): ``fsdp`` blocks over ``data`` x ``seq``, the rest
        over ``data`` x ``fsdp`` x ``seq``; one flat all-reduce per group."""
        out = dict(grads)
        for axes, fsdp in (((DATA_AXIS, SEQ_AXIS), True), (GRAD_AXES, False)):
            group = self.mesh.group(axes)
            names = [n for n in grads if (self.grad_axis.get(n) == FSDP_AXIS) == fsdp]
            if group is None or not names:
                continue
            flat = torch.cat([grads[n].reshape(-1) for n in names])
            flat = collectives.all_reduce(flat, "sum", group)
            i = 0
            for n in names:
                k = grads[n].numel()
                out[n] = flat[i:i + k].view_as(grads[n])
                i += k
        return out

    def global_sq_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The whole gradient's squared L2 norm from summed gradients: each
        axis's blocks' squared sums all-reduced over it, the replicated
        leaves' added (every rank gets the same value)."""
        sq = lambda names: sum((grads[n].float() * grads[n].float()).sum() for n in names)  # noqa: E731
        total = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
        for axis in (FSDP_AXIS, TENSOR_AXIS):
            names = [n for n in grads if self.grad_axis.get(n) == axis]
            if names:
                total = total + collectives.all_reduce(sq(names).reshape(1), "sum", self.mesh.group(axis)).reshape(())
        whole = [n for n in grads if self.grad_axis.get(n) is None]
        if whole:
            total = total + sq(whole)
        return total


def _trains(group: list) -> bool:
    """Whether a flat gather's group holds trainables (its gradient is
    reduce-scattered)."""
    owner, attr, _, _ = group[0]
    return owner._parameters[attr].requires_grad


def place_train_state(state, mesh: Mesh, specs: Optional[Dict[str, tuple]] = None,
                      frozen_replicated: bool = False) -> Zero:
    """Place ``state`` over ``mesh`` by ``specs`` (default:
    ``train_state_shardings(state, mesh, frozen_replicated=...)``),
    the JAX driver's ``jax.device_put(state, shardings)``: every rank keeps
    its blocks; ``state.zero`` and the optimizer's ``zero`` are set."""
    from i2v_adapter_tpu_torch.parallel.mesh import train_state_shardings

    if specs is None:
        specs = train_state_shardings(state, mesh, frozen_replicated=frozen_replicated)
    zero = Zero(mesh, specs)
    zero.place(state)
    zero.mark(state)
    state.zero = zero
    state.optimizer.zero = zero
    return zero
