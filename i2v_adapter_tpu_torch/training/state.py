"""Train state: trainable/frozen split, optimizer, EMA.

The counterpart of the JAX package's ``training/state.py``.  The freeze
policy is the same path rule: the I2V adapters' ``to_q``/``to_out`` train
(plus the motion modules with ``update_motion_modules``; everything in
``t2i`` mode), the rest of the UNet is frozen.  Where the JAX package splits
the parameter tree in two, the port sets ``requires_grad`` and keeps the two
name lists; autograd then computes no gradient for frozen weights.

``make_optimizer`` reproduces optax, not ``torch.optim``: the JAX step's
``chain(clip_by_global_norm, adamw)`` or ``chain(clip_by_global_norm,
adafactor)``, wrapped in ``MultiSteps`` when gradients accumulate, step for
step (see ``Optimizer``).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from i2v_adapter_tpu_torch.config import OptimizerConfig, TrainConfig
from i2v_adapter_tpu_torch.utils.convert import flax_layouts

Params = Dict[str, torch.Tensor]


def trainable_predicate(config: TrainConfig) -> Callable[[str], bool]:
    """Name predicate of the freeze policy on the port's dotted parameter
    names (which follow the Flax module names)."""
    if config.train_mode == "t2i":
        return lambda name: True

    def pred(name: str) -> bool:
        if "i2v_adapter" in name and ("to_q" in name or "to_out" in name):
            return True
        return bool(config.update_motion_modules and "motion_modules" in name)

    return pred


def partition_params(module: nn.Module, pred: Callable[[str], bool]) -> Tuple[List[str], List[str]]:
    """Set ``requires_grad`` by ``pred``; returns (trainable, frozen) names."""
    trainable, frozen = [], []
    for name, p in module.named_parameters():
        keep = pred(name)
        p.requires_grad_(keep)
        (trainable if keep else frozen).append(name)
    return trainable, frozen


# ---------------------------------------------------------------------------
# learning-rate schedules (optax's, evaluated at optax's count)
# ---------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init

    def fn(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return fn


def _cosine(init: float, steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init

    def fn(count: int) -> float:
        decay = 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
        return init * ((1.0 - alpha) * decay + alpha)

    return fn


def _join(first: Callable[[int], float], then: Callable[[int], float], boundary: int):
    return lambda count: first(count) if count < boundary else then(count - boundary)


def make_lr_schedule(config: OptimizerConfig, total_steps: int) -> Callable[[int], float]:
    base, warmup = config.learning_rate, config.lr_warmup_steps
    if config.lr_scheduler == "constant":
        return lambda count: base
    if config.lr_scheduler == "constant_with_warmup":
        return _join(_linear(0.0, base, warmup), lambda count: base, warmup)
    if config.lr_scheduler == "linear":
        return _join(_linear(0.0, base, warmup),
                     _linear(base, 0.0, max(total_steps - warmup, 1)), warmup)
    if config.lr_scheduler == "cosine":
        decay_steps = max(total_steps, warmup + 1)
        return _join(_linear(0.0, base, warmup), _cosine(base, decay_steps - warmup), warmup)
    raise ValueError(f"unknown lr_scheduler: {config.lr_scheduler}")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@dataclass
class OptState:
    """The optimizer's state: AdamW's moments (``mu``, ``nu``, in each
    parameter's layout) or Adafactor's second-moment statistics (``v_row``
    / ``v_col`` for factored leaves, ``v`` for the others, in the Flax
    layout, as optax keeps them), the inner update count, and the
    MultiSteps accumulator with its counters."""

    count: int = 0  # inner (clip + AdamW / Adafactor) updates made
    mu: Params = field(default_factory=dict)
    nu: Params = field(default_factory=dict)
    v_row: Params = field(default_factory=dict)
    v_col: Params = field(default_factory=dict)
    v: Params = field(default_factory=dict)
    mini_step: int = 0  # calls since the last inner update (accumulation)
    gradient_step: int = 0
    acc: Params = field(default_factory=dict)


# Adafactor's settings in the JAX package's make_optimizer (optax's
# adafactor defaults with no parameter scaling, clipping, momentum or decay)
ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the (second largest, largest) axes of a
    shape whose second largest axis has at least 128 entries, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _inverse(perm: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(int(i) for i in np.argsort(perm))


def adamw_updates(grads: Params, state: OptState, params: Params, lr: float, b1: float, b2: float,
                  eps: float, weight_decay: float) -> Params:
    """optax's ``adamw`` update for ``grads``, whose ``state.count`` the
    caller has already advanced to this update's: the moments in
    ``state.mu`` / ``state.nu`` updated in place, bias-corrected with
    ``decay ** count`` in fp32 as optax evaluates it, ``eps`` outside the
    square root, the decay added as ``weight_decay * p`` on the old
    parameters, the update scaled by ``-lr``."""
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.int32(state.count))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.int32(state.count))
    updates = {}
    for n, g in grads.items():
        mu, nu = state.mu[n], state.nu[n]
        mu.copy_((1.0 - b1) * g + b1 * mu)
        nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        u = u + weight_decay * params[n].detach().float()
        updates[n] = u * (-lr)
    return updates


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), inner)`` with
    ``inner`` the JAX package's ``adamw(schedule, ...)`` or
    ``adafactor(schedule, multiply_by_parameter_scale=False,
    clipping_threshold=None, momentum=None, weight_decay_rate=None)``, in
    ``optax.MultiSteps(k)`` when ``k = gradient_accumulation_steps > 1``.

    Differences from ``torch.optim`` it keeps on purpose:

    * clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``,
      with no ``+1e-6`` (``clip_grad_norm_`` adds one);
    * AdamW is optax's: bias-corrected moments, ``eps`` outside the square
      root, decay added as ``wd * p`` on the old parameters, the update
      scaled by ``-lr(count)`` with ``count`` the inner updates made so far;
    * Adafactor is optax's ``scale_by_factored_rms``: decay ``1 - (count +
      1) ** -0.8``, ``eps = 1e-30`` added to the squared gradient, factored
      row / column statistics for leaves whose two largest axes (of the
      Flax layout: ``layouts`` maps a parameter to the permutation that
      gives it) both hold at least 128 entries, a full statistic otherwise;
      the update ``-lr(count) * g / sqrt(v)``;
    * accumulation keeps the running mean of the gradients
      (``acc += (g - acc) / (n + 1)``) and makes the inner update on the
      k-th call; the calls in between return zeros and leave the state.

    ``update`` mutates ``state`` in place (the port keeps one copy of the
    moments) and returns the updates to add to the parameters."""

    def __init__(self, config: TrainConfig, total_steps: int):
        oc = config.optimizer
        self.config = oc
        self.kind = oc.optimizer
        self.schedule = make_lr_schedule(oc, total_steps)
        self.every_k = config.gradient_accumulation_steps
        self.layouts: Dict[str, Tuple[int, ...]] = {}

    def init(self, params: Params, layouts: Optional[Dict[str, Tuple[int, ...]]] = None) -> OptState:
        """A zero state for ``params``; ``layouts`` maps a parameter name to
        the permutation that turns it into its Flax layout
        (``utils.convert.flax_layouts``).  Adafactor needs it: it factors
        in that layout, as optax does on the JAX tree, and a statistic
        factored in the PyTorch layout would differ from optax's."""
        if self.kind == "adafactor" and layouts is None:
            raise ValueError("Adafactor factors in the Flax layout: pass layouts "
                             "(utils.convert.flax_layouts of the trained module)")
        self.layouts = dict(layouts or {})
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        state = OptState(acc=zeros() if self.every_k > 1 else {})
        if self.kind == "adamw":
            state.mu, state.nu = zeros(), zeros()
            return state
        for n, p in params.items():
            shape = self._flax(n, p).shape
            dims = factored_dims(tuple(shape))
            if dims is None:
                state.v[n] = torch.zeros(shape, dtype=torch.float32, device=p.device)
            else:
                d1, d0 = dims
                state.v_row[n] = torch.zeros([s for i, s in enumerate(shape) if i != d0],
                                             dtype=torch.float32, device=p.device)
                state.v_col[n] = torch.zeros([s for i, s in enumerate(shape) if i != d1],
                                             dtype=torch.float32, device=p.device)
        return state

    def _flax(self, name: str, x: torch.Tensor) -> torch.Tensor:
        perm = self.layouts.get(name)
        return x.permute(perm) if perm is not None else x

    def update(self, grads: Params, state: OptState, params: Params) -> Params:
        if self.every_k <= 1:
            return self._inner(grads, state, params)
        for n, g in grads.items():
            state.acc[n].add_((g - state.acc[n]) / (state.mini_step + 1))
        if state.mini_step < self.every_k - 1:
            state.mini_step += 1
            return {n: torch.zeros_like(g) for n, g in grads.items()}
        updates = self._inner(state.acc, state, params)
        state.mini_step = 0
        state.gradient_step += 1
        for acc in state.acc.values():
            acc.zero_()
        return updates

    def _inner(self, grads: Params, state: OptState, params: Params) -> Params:
        oc = self.config
        norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads.values()))
        clip = norm < oc.max_grad_norm
        grads = {n: torch.where(clip, g, (g / norm) * oc.max_grad_norm) for n, g in grads.items()}
        lr = self.schedule(state.count)
        state.count += 1
        if self.kind == "adafactor":
            return self._adafactor(grads, state, lr)
        return adamw_updates(grads, state, params, lr, oc.adam_beta1, oc.adam_beta2, oc.adam_epsilon,
                             oc.adam_weight_decay)

    def _adafactor(self, grads: Params, state: OptState, lr: float) -> Params:
        # the decay at the count before this update, in fp32 as optax has it
        t = np.float32(state.count)
        decay = np.float32(1.0) - t ** np.float32(-ADAFACTOR_DECAY_RATE)
        keep, take = float(decay), float(np.float32(1.0) - decay)
        updates = {}
        for n, g in grads.items():
            gf = self._flax(n, g.float())
            sq = gf * gf + ADAFACTOR_EPS
            if n in state.v:
                v = state.v[n]
                v.copy_(keep * v + take * sq)
                uf = gf * v ** -0.5
            else:
                d1, d0 = factored_dims(tuple(gf.shape))
                vr, vc = state.v_row[n], state.v_col[n]
                vr.copy_(keep * vr + take * sq.mean(dim=d0))
                vc.copy_(keep * vc + take * sq.mean(dim=d1))
                row_col_mean = vr.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
                row_factor = (vr / row_col_mean) ** -0.5
                col_factor = vc ** -0.5
                uf = gf * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            perm = self.layouts.get(n)
            u = uf.permute(_inverse(perm)) if perm is not None else uf
            updates[n] = (u * lr) * -1.0
        return updates


def make_optimizer(config: TrainConfig, total_steps: int) -> Optimizer:
    """The JAX package's optimizer stack (see ``Optimizer``).  With
    ``optimizer='adafactor'`` it warns when an Adam flag was set away from
    its default: classic Adafactor keeps no momentum and applies no weight
    decay, and Adam's epsilon is not its unit."""
    oc = config.optimizer
    if oc.optimizer == "adafactor":
        defaults = OptimizerConfig()
        ignored = [name for name in ("adam_beta1", "adam_beta2", "adam_weight_decay", "adam_epsilon")
                   if getattr(oc, name) != getattr(defaults, name)]
        if ignored:
            warnings.warn(
                f"optimizer='adafactor' ignores {', '.join(ignored)}: "
                "classic Adafactor keeps no momentum and applies no weight "
                "decay (see make_optimizer docstring); ported AdamW recipes "
                "lose both.  Use optimizer='adamw' to honor these flags.",
                stacklevel=2,
            )
    return Optimizer(config, total_steps)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


@dataclass
class TrainState:
    """Everything one training run carries from step to step.  The train
    step updates it in place and returns it."""

    step: int
    unet: nn.Module
    trainable: List[str]
    frozen: List[str]
    optimizer: Optimizer
    opt_state: OptState
    ema: Optional[Params] = None
    vae: Optional[nn.Module] = None
    text_encoder: Optional[nn.Module] = None
    image_encoder: Optional[nn.Module] = None

    def trainable_params(self) -> Params:
        named = dict(self.unet.named_parameters())
        return {n: named[n] for n in self.trainable}


def create_train_state(
    unet: nn.Module,
    config: TrainConfig,
    total_steps: int,
    vae: Optional[nn.Module] = None,
    text_encoder: Optional[nn.Module] = None,
    image_encoder: Optional[nn.Module] = None,
) -> TrainState:
    """Take ownership of the models: split the UNet by the freeze policy,
    keep trainables in fp32, cast the frozen weights and the towers to
    ``freeze_dtype`` in place, and set the UNet's activation checkpointing
    from ``gradient_checkpointing``."""
    trainable, frozen = partition_params(unet, trainable_predicate(config))
    if not trainable:
        raise ValueError("freeze policy produced no trainable parameters")
    named = dict(unet.named_parameters())
    with torch.no_grad():
        for n in trainable:
            named[n].data = named[n].data.float()
        if config.freeze_dtype == "bfloat16":
            for n in frozen:
                if named[n].dtype == torch.float32:
                    named[n].data = named[n].data.to(torch.bfloat16)
    towers = [vae, text_encoder, image_encoder]
    for m in towers:
        if m is not None:
            m.requires_grad_(False).eval()
            if config.freeze_dtype == "bfloat16":
                m.to(torch.bfloat16)
    unet.config = unet.config.replace(remat=config.gradient_checkpointing)
    optimizer = make_optimizer(config, total_steps)
    params = {n: named[n] for n in trainable}
    return TrainState(
        step=0, unet=unet, trainable=trainable, frozen=frozen, optimizer=optimizer,
        opt_state=optimizer.init(params, flax_layouts(unet, trainable)),
        ema={n: p.detach().clone() for n, p in params.items()} if config.use_ema else None,
        vae=vae, text_encoder=text_encoder, image_encoder=image_encoder,
    )


def ema_update(ema: Params, params: Params, decay: float) -> None:
    """In place: ``e = decay * e + (1 - decay) * p``."""
    with torch.no_grad():
        for n, e in ema.items():
            e.copy_(decay * e + (1.0 - decay) * params[n].detach())
