"""Weight carrier: Flax parameter trees -> the port's modules.

The port's parameter names follow the Flax module names, so a Flax leaf
``a/b/c/kernel`` lands on ``a.b.c.weight`` with one per-layer transpose:

* Dense ``kernel (in, out)``      -> ``Linear.weight (out, in)``
* Conv ``kernel (kh, kw, in, out)`` -> ``Conv2d.weight (out, in, kh, kw)``
* 3-D Conv ``kernel (kt, kh, kw, in, out)`` -> ``Conv3d.weight (out, in, kt, kh, kw)``
* LayerNorm/GroupNorm ``scale``     -> ``weight``
* Embed ``embedding``               -> ``weight``
* everything else (biases, raw parameters) as it is, and every leaf of a
  module whose ``flax_layout`` is true (its parameters carry the Flax
  names and shapes, e.g. ``DenseGeneral``'s multi-axis kernels).

``load_flax_params`` is strict: a missing, extra or misshapen leaf raises.

The second half is the port's copy of the JAX package's checkpoint key
maps: diffusers / transformers state dicts (``load_state_dict``) ->
Flax-named numpy trees (``convert_unet``, ``convert_vae``,
``convert_clip_text``, ``convert_clip_vision``), the IP-Adapter variant
detection, and the adapter-only ``extract_*`` / ``merge_*`` interchange.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn


def flatten_tree(tree: Mapping[str, Any], prefix: str = "", sep: str = ".") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays -> {"a.b.c": array} (``sep`` between keys)."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path + sep, sep))
        else:
            out[path] = np.asarray(value)
    return out


def _flax_leaves(module: nn.Module, params: Mapping[str, Any]):
    """``(name, array)`` per leaf of a Flax param tree (``{"params": ...}``
    or the inner tree): ``module``'s parameter name and the leaf in the
    PyTorch layout, a transposed view of the leaf where the layouts differ."""
    if set(params) == {"params"}:
        params = params["params"]
    modules = dict(module.named_modules())
    for path, value in flatten_tree(params).items():
        parent, _, leaf = path.rpartition(".")
        owner = modules.get(parent)
        if getattr(owner, "flax_layout", False):
            pass
        elif leaf == "kernel":
            if isinstance(owner, nn.Conv3d):
                value = value.transpose(4, 3, 0, 1, 2)
            elif isinstance(owner, nn.Conv2d):
                value = value.transpose(3, 2, 0, 1)
            elif isinstance(owner, nn.Linear):
                value = value.T
            else:
                raise KeyError(f"no Linear/Conv2d at {parent!r} for {path!r}")
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        yield (f"{parent}.{leaf}" if parent else leaf), value


def load_flax_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Fill ``module`` in place from a Flax param tree; strict.  Names and
    shapes are checked first; then each leaf goes through float32 into its
    parameter's dtype and device, one leaf at a time, so the host holds one
    converted leaf beside the tree."""
    incoming = dict(_flax_leaves(module, params))
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
            own[name].copy_(torch.from_numpy(np.array(value, dtype=np.float32, order="C")).to(own[name].dtype))
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


def _optax_states(tree):
    """Every NamedTuple state inside an optax state (chains and MultiSteps
    nest them in tuples)."""
    if isinstance(tree, tuple):
        if hasattr(tree, "_fields"):
            yield tree
        for item in tree:
            yield from _optax_states(item)


def _load_opt_state(state, opt_state) -> None:
    """Fill the port's ``OptState`` from a JAX optax state: AdamW's
    ``ScaleByAdamState`` or Adafactor's ``FactoredState`` (its statistics
    stay in the Flax layout), and ``MultiStepsState``'s counters and
    accumulator."""
    modules = dict(state.unet.named_modules())
    paths = {n: flax_leaf(modules, n) for n in state.trainable}

    def take(tree, name, permute=True):
        path, perm = paths[name]
        node = tree
        for part in path:
            node = node[part]
        value = torch.from_numpy(np.array(node, dtype=np.float32))
        return value.permute(tuple(np.argsort(perm))) if permute and perm is not None else value

    ours = state.opt_state
    kinds = {type(s).__name__: s for s in _optax_states(opt_state)}
    inner = {"adamw": "ScaleByAdamState", "adafactor": "FactoredState"}[state.optimizer.kind]
    if inner not in kinds:
        raise ValueError(f"the JAX optimizer state holds no {inner} ({sorted(kinds)})")
    found = kinds[inner]
    ours.count = int(found.count)
    with torch.no_grad():
        if inner == "ScaleByAdamState":
            for n in state.trainable:
                ours.mu[n].copy_(take(found.mu, n))
                ours.nu[n].copy_(take(found.nu, n))
        else:
            for key in ("v_row", "v_col", "v"):
                for n, t in getattr(ours, key).items():
                    t.copy_(take(getattr(found, key), n, permute=False))
        multi = kinds.get("MultiStepsState")
        if (multi is None) != (state.optimizer.every_k <= 1):
            raise ValueError("MultiSteps: present on one side only")
        if multi is not None:
            ours.mini_step, ours.gradient_step = int(multi.mini_step), int(multi.gradient_step)
            for n in state.trainable:
                ours.acc[n].copy_(take(multi.acc_grads, n))


def load_train_state(state, jax_state) -> Any:
    """Fill a port ``TrainState`` from a JAX ``TrainState``: its step, its
    trainable + frozen UNet trees, its optimizer state (AdamW or
    Adafactor, in MultiSteps or not), its EMA of the trainables (present on
    both sides or neither) and its VAE / text / image trees (each present
    on both sides).  Strict, like ``load_flax_params``; each tensor keeps
    its own dtype."""
    if (state.ema is None) != (getattr(jax_state, "ema", None) is None):
        raise ValueError("ema: present on one side only")
    if state.ema is not None:  # the EMA tree goes through the UNet's own names
        load_flax_params(state.unet, merge_trees(jax_state.frozen, jax_state.ema))
        named = dict(state.unet.named_parameters())
        for n, e in state.ema.items():
            e.copy_(named[n].detach())
    load_flax_params(state.unet, merge_trees(jax_state.frozen, jax_state.trainable))
    for name in ("vae", "text_encoder", "image_encoder"):
        tree, module = getattr(jax_state, name), getattr(state, name)
        if (tree is None) != (module is None):
            raise ValueError(f"{name}: present on one side only")
        if module is not None:
            load_flax_params(module, tree)
    _load_opt_state(state, jax_state.opt_state)
    state.step = int(jax_state.step)
    return state


def flax_leaf(modules: Mapping[str, nn.Module], name: str):
    """``(path, perm)`` of the parameter ``name`` of a module whose
    submodules are ``modules`` (``dict(module.named_modules())``): its
    Flax path parts (``kernel`` / ``scale`` / ``embedding`` for the leaf)
    and the permutation that turns the PyTorch layout into the Flax one
    (``tensor.permute(perm)``), or None where the two agree."""
    parent, _, leaf = name.rpartition(".")
    owner = modules.get(parent)
    perm = None
    if getattr(owner, "flax_layout", False):
        pass
    elif leaf == "weight" and isinstance(owner, nn.Conv3d):
        leaf, perm = "kernel", (2, 3, 4, 1, 0)
    elif leaf == "weight" and isinstance(owner, nn.Conv2d):
        leaf, perm = "kernel", (2, 3, 1, 0)
    elif leaf == "weight" and isinstance(owner, nn.Linear):
        leaf, perm = "kernel", (1, 0)
    elif leaf == "weight" and isinstance(owner, nn.Embedding):
        leaf = "embedding"
    elif leaf == "weight":
        leaf = "scale"
    return (parent.split(".") if parent else []) + [leaf], perm


def flax_layouts(module: nn.Module, names) -> Dict[str, tuple]:
    """``{name: perm}`` for the parameters among ``names`` whose Flax layout
    is a permutation of the PyTorch one (Linear, Conv2d and Conv3d weights)."""
    modules = dict(module.named_modules())
    out = {}
    for name in names:
        perm = flax_leaf(modules, name)[1]
        if perm is not None:
            out[name] = perm
    return out


def to_flax_tree(module: nn.Module, params: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """The inverse of ``load_flax_params``' mapping: ``params`` (default: all of
    ``module``'s parameters), tensors keyed by ``module``'s dotted parameter
    names and shaped like them, as a nested Flax-named tree of fp32 numpy
    arrays in Flax layouts."""
    modules = dict(module.named_modules())
    if params is None:
        params = dict(module.named_parameters())
    tree: dict = {}
    for name, tensor in params.items():
        path, perm = flax_leaf(modules, name)
        value = tensor.detach().float().cpu()
        if perm is not None:
            value = value.permute(perm)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(value.numpy())
    return tree


# ---------------------------------------------------------------------------
# diffusers / transformers checkpoints -> Flax-named numpy trees
#
# The key maps take flat
# ``str -> np.ndarray`` state dicts (``load_state_dict``) and return nested
# Flax-named trees of numpy arrays, which ``load_flax_params`` carries into
# the modules:
#   Linear  : torch (out, in)        -> kernel (in, out)
#   Conv    : torch (O, I, kh, kw)   -> kernel (kh, kw, I, O)
#   Norms   : weight -> scale
#   Embed   : weight -> embedding
# Without an adapter checkpoint the I2V adapter starts as the reference's
# zero-init no-op: Q/K/V copied from the frozen spatial attn1, the output
# projection zeroed.
# ---------------------------------------------------------------------------

Flat = Dict[str, np.ndarray]


def load_state_dict(path: str) -> Flat:
    """Load a ``.safetensors`` file (the port's own reader: dtypes as
    stored, BF16 widened to float32) or a torch ``.bin`` / ``.pt`` /
    ``.ckpt`` (``torch.load(weights_only=True)``, tensors as float32 numpy,
    nested dicts such as an IP-Adapter's kept) into numpy arrays."""
    if path.endswith(".safetensors"):
        from i2v_adapter_tpu_torch.utils.safetensors_io import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]

    def to_numpy(v):
        if isinstance(v, dict):
            return {k: to_numpy(x) for k, x in v.items()}
        return v.float().numpy() if hasattr(v, "numpy") else v

    return {k: to_numpy(v) for k, v in sd.items()}


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return tree


def _linear(sd: Flat, src: str, dst: str, out: Flat, bias: bool = True):
    out[f"{dst}/kernel"] = np.asarray(sd[f"{src}.weight"]).T
    if bias and f"{src}.bias" in sd:
        out[f"{dst}/bias"] = np.asarray(sd[f"{src}.bias"])


def _conv(sd: Flat, src: str, dst: str, out: Flat):
    out[f"{dst}/kernel"] = np.transpose(np.asarray(sd[f"{src}.weight"]), (2, 3, 1, 0))
    if f"{src}.bias" in sd:
        out[f"{dst}/bias"] = np.asarray(sd[f"{src}.bias"])


def _norm(sd: Flat, src: str, dst: str, out: Flat):
    out[f"{dst}/scale"] = np.asarray(sd[f"{src}.weight"])
    out[f"{dst}/bias"] = np.asarray(sd[f"{src}.bias"])


def _attention(sd: Flat, src: str, dst: str, out: Flat, ip: bool = False):
    """diffusers Attention: to_q/k/v (Linear, no bias), to_out.0 (Linear);
    with ``ip`` the IP-Adapter K/V of the attention processor."""
    _linear(sd, f"{src}.to_q", f"{dst}/to_q", out)
    _linear(sd, f"{src}.to_k", f"{dst}/to_k", out)
    _linear(sd, f"{src}.to_v", f"{dst}/to_v", out)
    _linear(sd, f"{src}.to_out.0", f"{dst}/to_out", out)
    if ip:
        _linear(sd, f"{src}.processor.to_k_ip", f"{dst}/to_k_ip", out)
        _linear(sd, f"{src}.processor.to_v_ip", f"{dst}/to_v_ip", out)


def _zero_init_adapter_from_attn1(flat: Flat, block_prefix: str):
    """i2v_adapter Q/K/V <- attn1 Q/K/V; to_out <- 0 (+ bias 0)."""
    for proj in ("to_q", "to_k", "to_v"):
        flat[f"{block_prefix}/i2v_adapter/{proj}/kernel"] = flat[
            f"{block_prefix}/attn1/{proj}/kernel"
        ].copy()
    out_kernel = flat[f"{block_prefix}/attn1/to_out/kernel"]
    flat[f"{block_prefix}/i2v_adapter/to_out/kernel"] = np.zeros_like(out_kernel)
    flat[f"{block_prefix}/i2v_adapter/to_out/bias"] = np.zeros(out_kernel.shape[1], dtype=out_kernel.dtype)


def _transformer_block(sd: Flat, src: str, dst: str, out: Flat, *, use_i2v_adapter: bool,
                       use_ip: bool, adapter_sd: Optional[Flat] = None,
                       adapter_src: Optional[str] = None):
    _norm(sd, f"{src}.norm1", f"{dst}/norm1", out)
    _norm(sd, f"{src}.norm2", f"{dst}/norm2", out)
    _norm(sd, f"{src}.norm3", f"{dst}/norm3", out)
    _attention(sd, f"{src}.attn1", f"{dst}/attn1", out)
    _attention(sd, f"{src}.attn2", f"{dst}/attn2", out, ip=use_ip)
    _linear(sd, f"{src}.ff.net.0.proj", f"{dst}/ff/proj", out)
    _linear(sd, f"{src}.ff.net.2", f"{dst}/ff/proj_out", out)
    if use_i2v_adapter:
        if adapter_sd is not None and f"{adapter_src}.to_q.weight" in adapter_sd:
            for proj in ("to_q", "to_k", "to_v"):
                _linear(adapter_sd, f"{adapter_src}.{proj}", f"{dst}/i2v_adapter/{proj}", out)
            _linear(adapter_sd, f"{adapter_src}.to_out.0", f"{dst}/i2v_adapter/to_out", out)
        else:
            _zero_init_adapter_from_attn1(out, dst)


def _spatial_transformer(sd: Flat, src: str, dst: str, out: Flat, *, num_layers: int,
                         use_linear_projection: bool, use_i2v_adapter: bool, use_ip: bool,
                         adapter_sd: Optional[Flat] = None, adapter_src: Optional[str] = None):
    _norm(sd, f"{src}.norm", f"{dst}/norm", out)
    proj = _linear if use_linear_projection else _conv
    proj(sd, f"{src}.proj_in", f"{dst}/proj_in", out)
    proj(sd, f"{src}.proj_out", f"{dst}/proj_out", out)
    for k in range(num_layers):
        _transformer_block(
            sd, f"{src}.transformer_blocks.{k}", f"{dst}/transformer_blocks_{k}", out,
            use_i2v_adapter=use_i2v_adapter, use_ip=use_ip, adapter_sd=adapter_sd,
            adapter_src=f"{adapter_src}.transformer_blocks.{k}.i2v_adapter" if adapter_src else None,
        )


def _temporal_transformer(sd: Flat, src: str, dst: str, out: Flat, num_layers: int = 1):
    """AnimateDiff motion module: a TransformerTemporalModel with two
    self-attentions; its positional embedding is analytic (not stored)."""
    _norm(sd, f"{src}.norm", f"{dst}/norm", out)
    _linear(sd, f"{src}.proj_in", f"{dst}/proj_in", out)
    _linear(sd, f"{src}.proj_out", f"{dst}/proj_out", out)
    for k in range(num_layers):
        bsrc, bdst = f"{src}.transformer_blocks.{k}", f"{dst}/transformer_blocks_{k}"
        _norm(sd, f"{bsrc}.norm1", f"{bdst}/norm1", out)
        _norm(sd, f"{bsrc}.norm2", f"{bdst}/norm2", out)
        _norm(sd, f"{bsrc}.norm3", f"{bdst}/norm3", out)
        _attention(sd, f"{bsrc}.attn1", f"{bdst}/attn1", out)
        _attention(sd, f"{bsrc}.attn2", f"{bdst}/attn2", out)
        _linear(sd, f"{bsrc}.ff.net.0.proj", f"{bdst}/ff/proj", out)
        _linear(sd, f"{bsrc}.ff.net.2", f"{bdst}/ff/proj_out", out)


def _resnet(sd: Flat, src: str, dst: str, out: Flat, time_emb: bool = True):
    _norm(sd, f"{src}.norm1", f"{dst}/norm1", out)
    _conv(sd, f"{src}.conv1", f"{dst}/conv1", out)
    if time_emb and f"{src}.time_emb_proj.weight" in sd:
        _linear(sd, f"{src}.time_emb_proj", f"{dst}/time_emb_proj", out)
    _norm(sd, f"{src}.norm2", f"{dst}/norm2", out)
    _conv(sd, f"{src}.conv2", f"{dst}/conv2", out)
    if f"{src}.conv_shortcut.weight" in sd:
        _conv(sd, f"{src}.conv_shortcut", f"{dst}/conv_shortcut", out)


# ---------------------------------------------------------------------------
# UNet (SD1.5 2D UNet + motion adapter + I2V adapter + IP-Adapter)
# ---------------------------------------------------------------------------


def _ip_site_order(config) -> list:
    """The attn2 sites (Flax prefixes) in the order of the torch model's
    ``attn_processors``: down blocks, up blocks, then the mid block (the up
    blocks' ModuleList is assigned before the mid block)."""
    sites = []
    for i, has in enumerate(config.down_block_has_attention):
        if has:
            for j in range(config.layers_per_block):
                for k in range(config.transformer_layers_per_block):
                    sites.append(f"down_blocks_{i}/attentions_{j}/transformer_blocks_{k}")
    for i, has in enumerate(config.up_block_has_attention):
        if has:
            for j in range(config.layers_per_block + 1):
                for k in range(config.transformer_layers_per_block):
                    sites.append(f"up_blocks_{i}/attentions_{j}/transformer_blocks_{k}")
    for k in range(config.transformer_layers_per_block):
        sites.append(f"mid_block/attentions_0/transformer_blocks_{k}")
    return sites


def detect_ip_adapter_variant(ip_adapter_sd: Mapping) -> tuple:
    """``(variant, num_image_tokens)`` of an IP-Adapter state dict, from its
    image-projection keys: ``proj.weight`` standard (4 tokens),
    ``proj.3.weight`` full_face (257), else plus (the latents' count)."""
    proj = ip_adapter_sd["image_proj"]
    if "proj.weight" in proj:
        return "standard", 4
    if "proj.3.weight" in proj:
        return "full_face", 257  # 256 CLIP patch tokens + 1 CLS
    return "plus", int(np.asarray(proj["latents"]).shape[1])


def ip_config_updates(ip_adapter_sd: Mapping) -> dict:
    """``VideoUNetConfig`` overrides derived from an IP-Adapter state dict:
    the variant, its token count and, for plus, the resampler's geometry."""
    variant, num_tokens = detect_ip_adapter_variant(ip_adapter_sd)
    upd = {"ip_variant": variant, "ip_num_tokens": num_tokens}
    proj = ip_adapter_sd["image_proj"]
    if variant == "plus":
        lat = np.asarray(proj["latents"])
        upd["ip_resampler_dim"] = int(lat.shape[-1])
        upd["ip_resampler_depth"] = len({k.split(".")[1] for k in proj if k.startswith("layers.")})
        upd["ip_hidden_dim"] = int(np.asarray(proj["proj_in.weight"]).shape[1])
    elif variant == "full_face":
        upd["ip_hidden_dim"] = int(np.asarray(proj["proj.0.weight"]).shape[1])
    return upd


def _convert_ip_image_proj(proj: Mapping, variant: str, out: Flat) -> None:
    """The image-projection head's leaves for ``variant`` (the original
    ip_adapter modules' key layouts)."""
    pre = "encoder_hid_proj"
    t = lambda key: np.asarray(proj[key]).T  # noqa: E731
    a = lambda key: np.asarray(proj[key])  # noqa: E731
    if variant == "standard":
        out[f"{pre}/proj/kernel"], out[f"{pre}/proj/bias"] = t("proj.weight"), a("proj.bias")
        out[f"{pre}/norm/scale"], out[f"{pre}/norm/bias"] = a("norm.weight"), a("norm.bias")
        return
    if variant == "full_face":  # nn.Sequential(Linear, GELU, Linear, LayerNorm) under 'proj.'
        out[f"{pre}/proj_0/kernel"], out[f"{pre}/proj_0/bias"] = t("proj.0.weight"), a("proj.0.bias")
        out[f"{pre}/proj_2/kernel"], out[f"{pre}/proj_2/bias"] = t("proj.2.weight"), a("proj.2.bias")
        out[f"{pre}/proj_3/scale"], out[f"{pre}/proj_3/bias"] = a("proj.3.weight"), a("proj.3.bias")
        return
    # plus: the perceiver resampler
    out[f"{pre}/latents"] = a("latents")[0]
    out[f"{pre}/proj_in/kernel"], out[f"{pre}/proj_in/bias"] = t("proj_in.weight"), a("proj_in.bias")
    out[f"{pre}/proj_out/kernel"], out[f"{pre}/proj_out/bias"] = t("proj_out.weight"), a("proj_out.bias")
    out[f"{pre}/norm_out/scale"], out[f"{pre}/norm_out/bias"] = a("norm_out.weight"), a("norm_out.bias")
    depth = len({k.split(".")[1] for k in proj if k.startswith("layers.")})
    for i in range(depth):
        attn, src = f"{pre}/layers_{i}_attn", f"layers.{i}.0"
        out[f"{attn}/norm1/scale"], out[f"{attn}/norm1/bias"] = a(f"{src}.norm1.weight"), a(f"{src}.norm1.bias")
        out[f"{attn}/norm2/scale"], out[f"{attn}/norm2/bias"] = a(f"{src}.norm2.weight"), a(f"{src}.norm2.bias")
        out[f"{attn}/to_q/kernel"] = t(f"{src}.to_q.weight")
        out[f"{attn}/to_kv/kernel"] = t(f"{src}.to_kv.weight")
        out[f"{attn}/to_out/kernel"] = t(f"{src}.to_out.weight")
        out[f"{pre}/layers_{i}_ff_norm/scale"] = a(f"layers.{i}.1.0.weight")
        out[f"{pre}/layers_{i}_ff_norm/bias"] = a(f"layers.{i}.1.0.bias")
        out[f"{pre}/layers_{i}_ff_in/kernel"] = t(f"layers.{i}.1.1.weight")
        out[f"{pre}/layers_{i}_ff_out/kernel"] = t(f"layers.{i}.1.3.weight")


def convert_unet(unet_sd: Flat, config, motion_sd: Optional[Flat] = None,
                 i2v_adapter_sd: Optional[Flat] = None, ip_adapter_sd: Optional[Mapping] = None) -> dict:
    """The VideoUNet tree from a diffusers UNet2DConditionModel state dict
    plus optional MotionAdapter, I2V-adapter and IP-Adapter weights: the 2D
    weights grafted per block, the motion modules loaded, the adapter
    zero-initialised from attn1 when absent, the IP K/V installed at the
    attn2 sites."""
    out: Flat = {}
    n, L = config.num_blocks, config.layers_per_block
    _conv(unet_sd, "conv_in", "conv_in", out)
    _linear(unet_sd, "time_embedding.linear_1", "time_embedding/linear_1", out)
    _linear(unet_sd, "time_embedding.linear_2", "time_embedding/linear_2", out)
    _norm(unet_sd, "conv_norm_out", "conv_norm_out", out)
    _conv(unet_sd, "conv_out", "conv_out", out)
    st_kwargs = dict(
        num_layers=config.transformer_layers_per_block,
        use_linear_projection=config.use_linear_projection,
        use_i2v_adapter=config.use_i2v_adapter,
        use_ip=False,  # the IP K/V are filled below (processor weights)
        adapter_sd=i2v_adapter_sd,
    )
    if not config.use_motion_modules:
        motion_sd = None

    def motion(src, dst):
        if motion_sd is not None:
            _temporal_transformer(motion_sd, f"{src}.temporal_transformer", dst, out)

    for i in range(n):
        for j in range(L):
            _resnet(unet_sd, f"down_blocks.{i}.resnets.{j}", f"down_blocks_{i}/resnets_{j}", out)
            if config.down_block_has_attention[i]:
                _spatial_transformer(unet_sd, f"down_blocks.{i}.attentions.{j}",
                                     f"down_blocks_{i}/attentions_{j}", out,
                                     **st_kwargs, adapter_src=f"down_blocks.{i}.attentions.{j}")
            motion(f"down_blocks.{i}.motion_modules.{j}", f"down_blocks_{i}/motion_modules_{j}")
        if i < n - 1:
            _conv(unet_sd, f"down_blocks.{i}.downsamplers.0.conv", f"down_blocks_{i}/downsamplers_0/conv", out)
    _resnet(unet_sd, "mid_block.resnets.0", "mid_block/resnets_0", out)
    _resnet(unet_sd, "mid_block.resnets.1", "mid_block/resnets_1", out)
    _spatial_transformer(unet_sd, "mid_block.attentions.0", "mid_block/attentions_0", out,
                         **st_kwargs, adapter_src="mid_block.attentions.0")
    if config.use_motion_mid_block:
        motion("mid_block.motion_modules.0", "mid_block/motion_modules_0")
    for i in range(n):
        for j in range(L + 1):
            _resnet(unet_sd, f"up_blocks.{i}.resnets.{j}", f"up_blocks_{i}/resnets_{j}", out)
            if config.up_block_has_attention[i]:
                _spatial_transformer(unet_sd, f"up_blocks.{i}.attentions.{j}",
                                     f"up_blocks_{i}/attentions_{j}", out,
                                     **st_kwargs, adapter_src=f"up_blocks.{i}.attentions.{j}")
            motion(f"up_blocks.{i}.motion_modules.{j}", f"up_blocks_{i}/motion_modules_{j}")
        if i < n - 1:
            _conv(unet_sd, f"up_blocks.{i}.upsamplers.0.conv", f"up_blocks_{i}/upsamplers_0/conv", out)

    if config.use_ip_adapter and ip_adapter_sd is not None:
        _convert_ip_image_proj(ip_adapter_sd["image_proj"], config.ip_variant, out)
        ip_sd = ip_adapter_sd["ip_adapter"]
        for key_id, site in zip(range(1, 1 << 30, 2), _ip_site_order(config)):
            out[f"{site}/attn2/to_k_ip/kernel"] = np.asarray(ip_sd[f"{key_id}.to_k_ip.weight"]).T
            out[f"{site}/attn2/to_v_ip/kernel"] = np.asarray(ip_sd[f"{key_id}.to_v_ip.weight"]).T
    elif config.use_ip_adapter:
        raise ValueError("config.use_ip_adapter=True but no ip_adapter_sd given")
    return _unflatten(out)


# ---------------------------------------------------------------------------
# adapter-only interchange (the reference's save / load of the adapters)
# ---------------------------------------------------------------------------


def _strip_params_wrapper(tree: dict) -> dict:
    """Accept either the inner param tree or the ``{'params': ...}`` wrapper."""
    return tree["params"] if set(tree.keys()) == {"params"} else tree


def _torch_parts(parts, names, after=None) -> list:
    """Flax path parts -> torch ones: ``name_i`` -> ``name``, ``i`` for the
    indexed containers in ``names`` (``after`` maps a container to a part
    inserted after its index)."""
    out = []
    for p in parts:
        name, _, idx = p.rpartition("_")
        if name in names and idx.isdigit():
            out.extend([name, idx])
            if after and name in after:
                out.append(after[name])
        else:
            out.append(p)
    return out


def extract_i2v_adapter(unet_params: dict, config=None) -> Flat:
    """The adapter's leaves of a VideoUNet tree in the torch
    I2VAdapterModule key layout (``...transformer_blocks.0.i2v_adapter.
    to_q.weight``, ``to_out.0.weight`` / ``.bias``)."""
    out: Flat = {}
    for key, val in flatten_tree(_strip_params_wrapper(unet_params), sep="/").items():
        if "i2v_adapter" not in key:
            continue
        parts = key.split("/")
        tname = ".".join(_torch_parts(parts[:-2], ("down_blocks", "up_blocks", "attentions",
                                                   "transformer_blocks", "resnets", "motion_modules")))
        proj, leaf = parts[-2], parts[-1]
        arr = np.asarray(val)
        if proj == "to_out":
            tkey = f"{tname}.to_out.0.{'weight' if leaf == 'kernel' else 'bias'}"
        else:
            tkey = f"{tname}.{proj}.weight"
        out[tkey] = arr.T if leaf == "kernel" else arr
    return out


def extract_motion_modules(unet_params: dict) -> Flat:
    """The motion modules' leaves of a VideoUNet tree in the MotionAdapter
    torch layout."""
    out: Flat = {}
    for key, val in flatten_tree(_strip_params_wrapper(unet_params), sep="/").items():
        if "motion_modules" not in key:
            continue
        parts = key.split("/")
        torch_parts = _torch_parts(parts[:-1], ("down_blocks", "up_blocks", "motion_modules",
                                                "transformer_blocks"),
                                   after={"motion_modules": "temporal_transformer"})
        leaf, arr = parts[-1], np.asarray(val)
        head = ".".join(torch_parts[:-1])
        suffix = "weight" if leaf == "kernel" else "bias"
        if parts[-2] == "to_out":
            tkey = f"{head}.to_out.0.{suffix}"
        elif parts[-2] == "proj" and parts[-3] == "ff":
            tkey = f"{head}.net.0.proj.{suffix}"
        elif parts[-2] == "proj_out" and parts[-3] == "ff":
            tkey = f"{head}.net.2.{suffix}"
        else:
            tkey = f"{'.'.join(torch_parts)}.{'weight' if leaf in ('kernel', 'scale') else leaf}"
        out[tkey] = arr.T if leaf == "kernel" else arr
    return out


def merge_motion_modules(unet_params: dict, motion_sd: Flat, config) -> dict:
    """Load a MotionAdapter torch state dict into an existing VideoUNet tree
    (each leaf keeps the tree's dtype)."""
    out: Flat = {}
    for i in range(config.num_blocks):
        for j in range(config.layers_per_block):
            _temporal_transformer(motion_sd, f"down_blocks.{i}.motion_modules.{j}.temporal_transformer",
                                  f"down_blocks_{i}/motion_modules_{j}", out)
        for j in range(config.layers_per_block + 1):
            _temporal_transformer(motion_sd, f"up_blocks.{i}.motion_modules.{j}.temporal_transformer",
                                  f"up_blocks_{i}/motion_modules_{j}", out)
    if config.use_motion_mid_block:
        _temporal_transformer(motion_sd, "mid_block.motion_modules.0.temporal_transformer",
                              "mid_block/motion_modules_0", out)
    flat = flatten_tree(_strip_params_wrapper(unet_params), sep="/")
    for k, v in out.items():
        if k not in flat:
            raise KeyError(f"motion key {k} not found in UNet params")
        flat[k] = np.asarray(v, dtype=np.asarray(flat[k]).dtype)
    return _unflatten(flat)


def merge_i2v_adapter(unet_params: dict, adapter_sd: Flat, config=None) -> dict:
    """Load a torch-layout adapter state dict into an existing VideoUNet
    tree (non-strict over the tree; each leaf keeps the tree's dtype);
    raises when the state dict holds no adapter key."""
    flat = flatten_tree(_strip_params_wrapper(unet_params), sep="/")
    updated = 0
    for tkey, arr in adapter_sd.items():
        if "i2v_adapter" not in tkey:
            continue
        parts, fparts, i = tkey.split("."), [], 0
        # down_blocks.0 -> down_blocks_0, to_out.0 -> to_out
        while i < len(parts):
            p = parts[i]
            if p == "to_out":
                fparts.append("to_out")
                i += 2
            elif i + 1 < len(parts) and parts[i + 1].isdigit():
                fparts.append(f"{p}_{parts[i + 1]}")
                i += 2
            else:
                fparts.append(p)
                i += 1
        leaf = {"weight": "kernel", "bias": "bias"}[fparts.pop()]
        fkey = "/".join(fparts) + f"/{leaf}"
        if fkey not in flat:
            raise KeyError(f"adapter key {tkey} -> {fkey} not found in UNet params")
        arr = np.asarray(arr)
        flat[fkey] = (arr.T if leaf == "kernel" else arr).astype(np.asarray(flat[fkey]).dtype)
        updated += 1
    if updated == 0:
        raise ValueError("no i2v_adapter keys found in state dict")
    return _unflatten(flat)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def _vae_attention(sd: Flat, src: str, dst: str, out: Flat):
    """New-style diffusers keys (to_q/to_k/to_v/to_out.0) or the legacy ones
    (query/key/value/proj_attn, possibly 1x1 convs); both occur for SD1.5."""
    legacy = f"{src}.query.weight" in sd
    names = (("to_q", "query"), ("to_k", "key"), ("to_v", "value"), ("to_out", "proj_attn")) if legacy \
        else (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0"))
    _norm(sd, f"{src}.group_norm", f"{dst}/group_norm", out)
    for ours, theirs in names:
        w = np.asarray(sd[f"{src}.{theirs}.weight"])
        if w.ndim == 4:  # legacy 1x1 conv
            w = w[:, :, 0, 0]
        out[f"{dst}/{ours}/kernel"] = w.T
        out[f"{dst}/{ours}/bias"] = np.asarray(sd[f"{src}.{theirs}.bias"])


def convert_vae(vae_sd: Flat, config) -> dict:
    out: Flat = {}
    n, L = len(config.block_out_channels), config.layers_per_block
    res = lambda src, dst: _resnet(vae_sd, src, dst, out, time_emb=False)  # noqa: E731
    _conv(vae_sd, "encoder.conv_in", "encoder/conv_in", out)
    for i in range(n):
        for j in range(L):
            res(f"encoder.down_blocks.{i}.resnets.{j}", f"encoder/down_{i}_resnets_{j}")
        if i < n - 1:
            _conv(vae_sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", f"encoder/down_{i}_downsample/conv", out)
    res("encoder.mid_block.resnets.0", "encoder/mid_resnets_0")
    _vae_attention(vae_sd, "encoder.mid_block.attentions.0", "encoder/mid_attn", out)
    res("encoder.mid_block.resnets.1", "encoder/mid_resnets_1")
    _norm(vae_sd, "encoder.conv_norm_out", "encoder/conv_norm_out", out)
    _conv(vae_sd, "encoder.conv_out", "encoder/conv_out", out)

    _conv(vae_sd, "decoder.conv_in", "decoder/conv_in", out)
    res("decoder.mid_block.resnets.0", "decoder/mid_resnets_0")
    _vae_attention(vae_sd, "decoder.mid_block.attentions.0", "decoder/mid_attn", out)
    res("decoder.mid_block.resnets.1", "decoder/mid_resnets_1")
    for i in range(n):
        for j in range(L + 1):
            res(f"decoder.up_blocks.{i}.resnets.{j}", f"decoder/up_{i}_resnets_{j}")
        if i < n - 1:
            _conv(vae_sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", f"decoder/up_{i}_upsample/conv", out)
    _norm(vae_sd, "decoder.conv_norm_out", "decoder/conv_norm_out", out)
    _conv(vae_sd, "decoder.conv_out", "decoder/conv_out", out)
    _conv(vae_sd, "quant_conv", "quant_conv", out)
    _conv(vae_sd, "post_quant_conv", "post_quant_conv", out)
    return _unflatten(out)


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def _clip_layers(sd: Flat, src: str, dst: str, out: Flat, num_layers: int):
    for i in range(num_layers):
        s, d = f"{src}.layers.{i}", f"{dst}layers_{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{s}.self_attn.{proj}", f"{d}/self_attn/{proj}", out)
        _norm(sd, f"{s}.layer_norm1", f"{d}/layer_norm1", out)
        _norm(sd, f"{s}.layer_norm2", f"{d}/layer_norm2", out)
        _linear(sd, f"{s}.mlp.fc1", f"{d}/mlp/fc1", out)
        _linear(sd, f"{s}.mlp.fc2", f"{d}/mlp/fc2", out)


def convert_clip_text(sd: Flat, config) -> dict:
    out: Flat = {}
    p = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    out["token_embedding/embedding"] = np.asarray(sd[f"{p}embeddings.token_embedding.weight"])
    out["position_embedding"] = np.asarray(sd[f"{p}embeddings.position_embedding.weight"])
    _clip_layers(sd, f"{p}encoder", "", out, config.num_hidden_layers)
    _norm(sd, f"{p}final_layer_norm", "final_layer_norm", out)
    return _unflatten(out)


def convert_clip_vision(sd: Flat, config) -> dict:
    out: Flat = {}
    p = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""
    out["patch_embedding/kernel"] = np.transpose(
        np.asarray(sd[f"{p}embeddings.patch_embedding.weight"]), (2, 3, 1, 0))
    out["class_embedding"] = np.asarray(sd[f"{p}embeddings.class_embedding"])
    out["position_embedding"] = np.asarray(sd[f"{p}embeddings.position_embedding.weight"])
    _norm(sd, f"{p}pre_layrnorm", "pre_layrnorm", out)
    _clip_layers(sd, f"{p}encoder", "", out, config.num_hidden_layers)
    _norm(sd, f"{p}post_layernorm", "post_layernorm", out)
    _linear(sd, "visual_projection", "visual_projection", out, bias=False)
    return _unflatten(out)
