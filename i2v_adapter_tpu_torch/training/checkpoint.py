"""Training checkpoints: adapter-only epoch checkpoints, full train states
and the whole-pipeline export.

The port's counterpart of the JAX package's ``training/checkpoint.py``,
writing the same files:

1. **Adapter epoch checkpoints** (``save_adapter_checkpoint`` /
   ``load_adapter_checkpoint``): ``<dir>/i2v_adapter/
   diffusion_pytorch_model.safetensors`` (fp32, the torch key layout of
   ``utils.convert.extract_i2v_adapter``) with its ``config.json``, and
   ``<dir>/motion_modules/`` when the motion modules train.  These are what
   ``from_pretrained(..., i2v_adapter_path)``, the CLI and the daemon read.
2. **Full train states** (``TrainCheckpointer``): the JAX package writes
   them with Orbax, which the port does not use.  The port writes one
   ``step_<N>.safetensors`` per step through ``utils.safetensors_io``,
   every tensor under its Flax-tree name (``trainable/...``,
   ``frozen/...``, ``opt_state/{mu,nu,v_row,v_col,v,acc}/...``, ``ema/...``,
   ``vae/...``, ``text_encoder/...``, ``image_encoder/...``) in its own
   dtype, with the counters as int64 scalars (``step``,
   ``opt_state/{count,mini_step,gradient_step}``).  Writes go to a
   temporary name and are renamed into place.
3. **Pipeline export** (``export_pipeline`` / ``load_pipeline_params``):
   ``<dir>/<model>/flax_model.safetensors`` under the ``/``-joined Flax keys
   (``params/...``) plus ``model_config.json`` and ``train_config.json``;
   the JAX ``load_pipeline_params`` reads what the port writes and the
   other way round.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from i2v_adapter_tpu_torch.utils import convert
from i2v_adapter_tpu_torch.utils.convert import flax_leaf
from i2v_adapter_tpu_torch.utils.safetensors_io import load_file, save_file

Tensors = Dict[str, torch.Tensor]


def find_latest_epoch(task_dir: str) -> Optional[int]:
    """The highest N of the ``epoch_N`` subdirectories of ``task_dir``, or
    None when there is none (or no ``task_dir``)."""
    if not os.path.isdir(task_dir):
        return None
    best = None
    for name in os.listdir(task_dir):
        m = re.fullmatch(r"epoch_(\d+)", name)
        if m:
            n = int(m.group(1))
            best = n if best is None or n > best else best
    return best


def flax_tensors(module: nn.Module, overrides: Optional[Mapping[str, torch.Tensor]] = None,
                 prefix: str = "") -> Tensors:
    """Every parameter of ``module`` (the tensor of ``overrides`` for the
    names it holds) under its ``/``-joined Flax key, ``prefix`` first: a
    view in the Flax layout, in the tensor's own dtype and on its device."""
    modules = dict(module.named_modules())
    out = {}
    for name, p in module.named_parameters():
        t = (overrides[name] if overrides is not None and name in overrides else p).detach()
        path, perm = flax_leaf(modules, name)
        out["/".join(([prefix] if prefix else []) + path)] = t.permute(perm) if perm is not None else t
    return out


def _write_atomic(tensors: Mapping[str, object], path: str, metadata=None) -> int:
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        n = save_file(tensors, tmp, metadata=metadata)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return n


# ---------------------------------------------------------------------------
# 1. adapter-only interchange checkpoints
# ---------------------------------------------------------------------------


def _adapter_tree(unet, params: Optional[Mapping[str, torch.Tensor]]) -> dict:
    """A Flax tree holding (at least) the adapter and motion leaves: ``unet``
    itself when it is a tree, else its parameters (``params`` overriding)."""
    if not isinstance(unet, nn.Module):
        return unet
    named = {n: (params[n] if params is not None and n in params else p)
             for n, p in unet.named_parameters() if "i2v_adapter" in n or "motion_modules" in n}
    return convert.to_flax_tree(unet, named)


def save_adapter_checkpoint(unet, config, directory: str, save_motion: bool = False,
                            params: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """Write an epoch-style adapter checkpoint (torch-layout fp32
    safetensors) from a UNet module (``params`` replacing some of its
    tensors, e.g. an EMA) or a Flax param tree."""
    tree = _adapter_tree(unet, params)
    os.makedirs(os.path.join(directory, "i2v_adapter"), exist_ok=True)
    adapter_sd = {k: np.ascontiguousarray(v, dtype=np.float32)
                  for k, v in convert.extract_i2v_adapter(tree, config).items()}
    _write_atomic(adapter_sd, os.path.join(directory, "i2v_adapter", "diffusion_pytorch_model.safetensors"))
    with open(os.path.join(directory, "i2v_adapter", "config.json"), "w") as f:
        json.dump({"_class_name": "I2VAdapterModule", **config.to_dict()}, f)
    if save_motion:
        motion_sd = {k: np.ascontiguousarray(v, dtype=np.float32)
                     for k, v in convert.extract_motion_modules(tree).items()}
        os.makedirs(os.path.join(directory, "motion_modules"), exist_ok=True)
        _write_atomic(motion_sd, os.path.join(directory, "motion_modules",
                                              "diffusion_pytorch_model.safetensors"))


def load_adapter_checkpoint(unet, config, directory: str):
    """Merge an adapter checkpoint (and its motion modules, when present)
    into a UNet: in place into a module's parameters (each keeps its
    dtype), returning the module; or into a Flax tree, returning the merged
    tree (non-strict over the tree)."""
    path = os.path.join(directory, "i2v_adapter", "diffusion_pytorch_model.safetensors")
    motion_path = os.path.join(directory, "motion_modules", "diffusion_pytorch_model.safetensors")
    tree = _adapter_tree(unet, None)
    tree = convert.merge_i2v_adapter(tree, convert.load_state_dict(path), config)
    if os.path.exists(motion_path):
        tree = convert.merge_motion_modules(tree, convert.load_state_dict(motion_path), config)
    if not isinstance(unet, nn.Module):
        return tree
    flat = convert.flatten_tree(convert._strip_params_wrapper(tree), sep="/")
    modules = dict(unet.named_modules())
    with torch.no_grad():
        for name, p in unet.named_parameters():
            path, perm = flax_leaf(modules, name)
            value = flat.get("/".join(path))  # the adapter and motion leaves only
            if value is None:
                continue
            target = p.permute(perm) if perm is not None else p
            target.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    return unet


# ---------------------------------------------------------------------------
# 2. full train-state checkpoints
# ---------------------------------------------------------------------------

FORMAT = "i2v_adapter_tpu_torch.train_state/1"
_COUNTERS = ("step", "opt_state/count", "opt_state/mini_step", "opt_state/gradient_step")


def state_entries(state):
    """Every tensor slot of a ``TrainState``: ``(name, slots, key, perm,
    param)`` with ``slots[key]`` the tensor (a module's ``_parameters`` for
    a parameter, else the optimizer's or the EMA's dict), ``name`` its
    Flax-tree name, ``perm`` the permutation that gives its Flax layout
    (None when it is in that layout) and ``param`` the dotted name of the
    parameter it belongs to (in the UNet or its tower): the trainable and
    frozen UNet parameters, the optimizer's statistics (the Adafactor ones
    already in the Flax layout), the MultiSteps accumulator, the EMA and
    the frozen towers, in that order."""
    unet_modules = dict(state.unet.named_modules())

    def param(prefix, modules, n):
        owner, _, attr = n.rpartition(".")
        path, perm = flax_leaf(modules, n)
        return "/".join([prefix] + path), modules[owner]._parameters, attr, perm, n

    for n in state.trainable:
        yield param("trainable", unet_modules, n)
    for n in state.frozen:
        yield param("frozen", unet_modules, n)
    os_ = state.opt_state
    for key in ("mu", "nu", "acc", "v_row", "v_col", "v"):
        slots = getattr(os_, key)
        for n in slots:
            path, perm = flax_leaf(unet_modules, n)
            yield ("/".join([f"opt_state/{key}"] + path), slots, n,
                   perm if key in ("mu", "nu", "acc") else None, n)
    for n in (state.ema or {}):
        path, perm = flax_leaf(unet_modules, n)
        yield "/".join(["ema"] + path), state.ema, n, perm, n
    for tower in ("vae", "text_encoder", "image_encoder"):
        module = getattr(state, tower)
        if module is not None:
            modules = dict(module.named_modules())
            for n, _ in module.named_parameters():
                yield param(tower, modules, n)


def train_state_tensors(state) -> Tensors:
    """Every tensor of a ``TrainState`` under its Flax-tree name
    (``state_entries``), as views of the live tensors in the Flax layout
    (writing into one writes into the state).  Over a mesh these are this
    rank's blocks (``parallel.zero``)."""
    out: Tensors = {}
    for name, slots, key, perm, _ in state_entries(state):
        t = slots[key].detach()
        out[name] = t.permute(perm) if perm is not None else t
    return out


def _counters(state) -> Dict[str, int]:
    os_ = state.opt_state
    return {"step": state.step, "opt_state/count": os_.count, "opt_state/mini_step": os_.mini_step,
            "opt_state/gradient_step": os_.gradient_step}


class TrainCheckpointer:
    """Save and restore whole ``TrainState``s under ``directory`` as
    ``step_<N>.safetensors``, keeping the newest ``max_to_keep``.

    With ``async_save`` a ``save`` returns once every tensor has been
    copied to host memory, and the file is written on a background thread
    (a second ``save`` first waits for the one in flight); ``wait()``
    blocks until it is on disk.  ``restore`` fills a state of the same
    structure in place, bit for bit.

    A state placed over a mesh (``state.zero``) is gathered by every rank
    (each must call ``save``), and rank 0 writes the file one card writes;
    ``restore`` on any mesh takes each rank's blocks of the whole tensors
    in the file, so one card restores a meshed run's file and the other
    way round."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # per save: step, bytes, seconds to the file's rename and (async)
        # seconds until save() returned
        self.saves: list = []
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.safetensors")

    def steps(self) -> list:
        found = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)\.safetensors", name)
            if m:
                found.append(int(m.group(1)))
        return sorted(found)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        import time

        self.wait()
        t0 = time.perf_counter()
        tensors = {k: torch.tensor(v, dtype=torch.int64) for k, v in _counters(state).items()}
        zero = getattr(state, "zero", None)
        if zero is None:
            live = train_state_tensors(state)
        else:  # every rank gathers, rank 0 writes what one card would
            live = zero.full_tensors(state)
            if zero.mesh.rank != 0:
                return
        metadata = {"format": FORMAT, "optimizer": state.optimizer.kind}
        if self.async_save:
            tensors.update({k: v.to("cpu", copy=True) for k, v in live.items()})
            snapshot_s = time.perf_counter() - t0

            def write():
                try:
                    self._finish(step, tensors, metadata, t0, snapshot_s)
                except BaseException as e:  # noqa: BLE001 - reraised by wait()
                    self._error = e

            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            tensors.update(live)
            self._finish(step, tensors, metadata, t0, None)

    def _finish(self, step, tensors, metadata, t0, snapshot_s) -> None:
        import time

        nbytes = _write_atomic(tensors, self.path(step), metadata)
        if self.max_to_keep is not None:
            for old in self.steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
                os.remove(self.path(old))
        self.saves.append({"step": int(step), "bytes": nbytes, "seconds": time.perf_counter() - t0,
                           "snapshot_s": snapshot_s})

    def wait(self) -> None:
        """Block until any in-flight save is on disk (re-raising its error)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, state, step: Optional[int] = None):
        """Fill ``state`` from the checkpoint at ``step`` (default: the
        newest); returns ``(state, step)``, or ``(None, None)`` when there
        is none.  Names, shapes and the optimizer kind must match."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        arrays = load_file(self.path(step))
        live = train_state_tensors(state)
        want = set(live) | set(_COUNTERS)
        if set(arrays) != want:
            raise KeyError(f"train state mismatch at step {step}: missing {sorted(want - set(arrays))[:8]} "
                           f"extra {sorted(set(arrays) - want)[:8]}")
        zero = getattr(state, "zero", None)
        for key, target in live.items():
            shape = tuple(target.shape) if zero is None else zero.full_flax_shape(key, target)
            if tuple(arrays[key].shape) != shape:
                raise ValueError(f"{key}: {tuple(arrays[key].shape)} in the file, {shape} here")
        with torch.no_grad():
            for key, target in live.items():
                whole = torch.from_numpy(arrays[key])
                if zero is not None and key in zero.dims:  # this rank's block of what one card wrote
                    whole = zero.block(whole, *zero.spec_axis(zero.specs[key]))
                target.copy_(whole)
        counters = {k: int(arrays[k]) for k in _COUNTERS}
        state.step = counters["step"]
        state.opt_state.count = counters["opt_state/count"]
        state.opt_state.mini_step = counters["opt_state/mini_step"]
        state.opt_state.gradient_step = counters["opt_state/gradient_step"]
        return state, step


# ---------------------------------------------------------------------------
# 3. whole-pipeline export
# ---------------------------------------------------------------------------


def _flat_tensors(tree, prefix: str = "") -> Dict[str, object]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flat_tensors(value, path + "/"))
        else:
            out[path] = value
    return out


def export_pipeline(params: Mapping[str, Union[nn.Module, Mapping]], model_config, directory: str,
                    train_config=None) -> int:
    """Write each model (an ``nn.Module``, whose parameters are written
    under ``params/<Flax path>``, or a nested Flax tree / ``/``-keyed map of
    arrays or tensors, e.g. from ``flax_tensors(unet, ema, "params")``) to
    ``<directory>/<name>/flax_model.safetensors``, each tensor in its own
    dtype, plus ``model_config.json`` and ``train_config.json``; returns the
    bytes written."""
    os.makedirs(directory, exist_ok=True)
    total = 0
    for name, value in params.items():
        flat = flax_tensors(value, prefix="params") if isinstance(value, nn.Module) else _flat_tensors(value)
        sub = os.path.join(directory, name)
        os.makedirs(sub, exist_ok=True)
        total += _write_atomic(flat, os.path.join(sub, "flax_model.safetensors"))
    with open(os.path.join(directory, "model_config.json"), "w") as f:
        f.write(model_config.to_json())
    if train_config is not None:
        with open(os.path.join(directory, "train_config.json"), "w") as f:
            f.write(train_config.to_json())
    return total


def load_pipeline_params(directory: str) -> dict:
    """``{model: nested Flax tree of numpy arrays}`` for every
    ``<model>/flax_model.safetensors`` under ``directory`` (BF16 tensors as
    float32)."""
    params = {}
    for name in os.listdir(directory):
        path = os.path.join(directory, name, "flax_model.safetensors")
        if os.path.exists(path):
            params[name] = convert._unflatten(load_file(path))
    return params
