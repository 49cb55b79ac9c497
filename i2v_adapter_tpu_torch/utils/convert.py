"""Weight carrier: Flax parameter trees -> the port's modules.

The port's parameter names follow the Flax module names, so a Flax leaf
``a/b/c/kernel`` lands on ``a.b.c.weight`` with one per-layer transpose:

* Dense ``kernel (in, out)``      -> ``Linear.weight (out, in)``
* Conv ``kernel (kh, kw, in, out)`` -> ``Conv2d.weight (out, in, kh, kw)``
* LayerNorm/GroupNorm ``scale``     -> ``weight``
* Embed ``embedding``               -> ``weight``
* everything else (biases, raw parameters) as it is.

``load_flax_params`` is strict: a missing, extra or misshapen leaf raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays -> {"a.b.c": array}."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path + "."))
        else:
            out[path] = np.asarray(value)
    return out


def flax_to_state_dict(module: nn.Module, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a Flax param tree (``{"params": ...}`` or the inner tree) onto
    ``module``'s parameter names, transposed to PyTorch layouts."""
    if set(params) == {"params"}:
        params = params["params"]
    modules = dict(module.named_modules())
    out = {}
    for path, value in flatten_tree(params).items():
        parent, _, leaf = path.rpartition(".")
        owner = modules.get(parent)
        if leaf == "kernel":
            if isinstance(owner, nn.Conv2d):
                value = value.transpose(3, 2, 0, 1)
            elif isinstance(owner, nn.Linear):
                value = value.T
            else:
                raise KeyError(f"no Linear/Conv2d at {parent!r} for {path!r}")
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[f"{parent}.{leaf}" if parent else leaf] = torch.from_numpy(
            np.array(value, dtype=np.float32, order="C")
        )
    return out


def load_flax_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Fill ``module`` in place from a Flax param tree; strict."""
    incoming = flax_to_state_dict(module, params)
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(incoming))
    extra = sorted(set(incoming) - set(own))
    if missing or extra:
        raise KeyError(f"param tree mismatch: missing {missing[:8]} extra {extra[:8]}"
                       f" ({len(missing)} missing, {len(extra)} extra)")
    for name, value in incoming.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"shape mismatch at {name}: {tuple(value.shape)} vs {tuple(own[name].shape)}")
    with torch.no_grad():
        for name, value in incoming.items():
            own[name].copy_(value.to(own[name].dtype))
    return module


def merge_trees(frozen: Mapping[str, Any], trainable: Mapping[str, Any]) -> dict:
    """Nested-dict union (the JAX ``merge_params``): trainable leaves win."""
    out = {k: v for k, v in frozen.items()}
    for key, value in trainable.items():
        if isinstance(value, Mapping) and isinstance(out.get(key), Mapping):
            out[key] = merge_trees(out[key], value)
        else:
            out[key] = value
    return out


def load_train_state(state, jax_state) -> Any:
    """Fill a port ``TrainState``'s models from a JAX ``TrainState``: its
    trainable + frozen UNet trees and its VAE / text / image trees (each
    present on both sides).  Strict, like ``load_flax_params``; each
    parameter keeps its own dtype."""
    load_flax_params(state.unet, merge_trees(jax_state.frozen, jax_state.trainable))
    for name in ("vae", "text_encoder", "image_encoder"):
        tree, module = getattr(jax_state, name), getattr(state, name)
        if (tree is None) != (module is None):
            raise ValueError(f"{name}: present on one side only")
        if module is not None:
            load_flax_params(module, tree)
    return state


def to_flax_tree(module: nn.Module, params: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """The inverse of ``flax_to_state_dict``: ``params`` (default: all of
    ``module``'s parameters), tensors keyed by ``module``'s dotted parameter
    names and shaped like them, as a nested Flax-named tree of fp32 numpy
    arrays in Flax layouts."""
    modules = dict(module.named_modules())
    if params is None:
        params = dict(module.named_parameters())
    tree: dict = {}
    for name, tensor in params.items():
        value = tensor.detach().float().cpu().numpy()
        parent, _, leaf = name.rpartition(".")
        owner = modules.get(parent)
        if leaf == "weight" and isinstance(owner, nn.Conv2d):
            leaf, value = "kernel", value.transpose(2, 3, 1, 0)
        elif leaf == "weight" and isinstance(owner, nn.Linear):
            leaf, value = "kernel", value.T
        elif leaf == "weight" and isinstance(owner, nn.Embedding):
            leaf = "embedding"
        elif leaf == "weight":
            leaf = "scale"
        node = tree
        for part in parent.split(".") if parent else []:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(value)
    return tree
