"""LoRA merging and textual inversion (the port's copy of the JAX package's
``utils/lora.py``).

LoRA weights are merged into the UNet's parameters in place, ``W += scale *
(alpha / rank) * up @ down``, as the reference's ``LoraLoaderMixin`` fuses
them for serving: no cost per step, and un-merging is reloading the base
weights.  Two key layouts are read:

* diffusers / peft: ``[unet.]<module path>.lora_A.weight`` (down) and
  ``.lora_B.weight`` (up);
* kohya: ``lora_unet_<module path with underscores>.lora_down.weight`` /
  ``.lora_up.weight`` and ``.alpha``, the underscores turned back into dots
  except inside the multi-word module names of ``_KOHYA_TOKENS``.

Module paths are the diffusers UNet's; ``_torch_path_to_port`` maps them
onto the port's module names, which follow the Flax ones (``to_out.0`` ->
``to_out``, ``ff.net.0.proj`` -> ``ff.proj``, ``ff.net.2`` ->
``ff.proj_out``, ``<name>.<i>`` -> ``<name>_<i>``).  Text-encoder keys are
skipped.  A 2-D pair patches the ``Linear`` of that name, as in the JAX
package; a 4-D pair (kohya's conv LoRA: a ``kh x kw`` down, a 1 x 1 up)
patches the conv of that name, which the JAX package cannot merge.  A pair
whose product does not have its target's shape is skipped with a warning.

``load_textual_inversion`` appends a learned embedding's rows to the CLIP
text encoder's token table and registers the placeholder token(s) with the
tokenizer.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

logger = logging.getLogger(__name__)


def _torch_path_to_port(path: str) -> str:
    """A diffusers UNet module path -> the port's module name."""
    parts = path.split(".")
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if i + 1 < len(parts) and parts[i + 1].isdigit():
            if p == "to_out":
                out.append("to_out")
                i += 2
                continue
            if p == "net":  # ff.net.0.proj -> ff.proj ; ff.net.2 -> ff.proj_out
                if parts[i + 1] == "0":
                    out.append("proj")
                    i += 3
                else:
                    out.append("proj_out")
                    i += 2
                continue
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
        else:
            out.append(p)
            i += 1
    return ".".join(out)


# kohya flattens module paths with underscores; these multi-word module
# names must survive the underscore -> dot recovery
_KOHYA_TOKENS = (
    "down_blocks", "up_blocks", "mid_block", "transformer_blocks",
    "motion_modules", "to_q", "to_k", "to_v", "to_out", "proj_in",
    "proj_out", "time_emb_proj", "conv_shortcut", "i2v_adapter",
    "ff_net", "conv_in", "conv_out",
)


def _repair_kohya_name(name: str) -> str:
    """'down_blocks_0_attentions_0_..._to_q' -> 'down_blocks.0.attentions...'"""
    guarded = name
    for tok in _KOHYA_TOKENS:
        guarded = guarded.replace(tok, tok.replace("_", "\0"))
    guarded = guarded.replace("_", ".").replace("\0", "_")
    return guarded.replace("ff_net", "ff.net")


_PATTERNS = (
    # diffusers / peft: unet.<dotted path>.lora_A / lora_B.weight
    (re.compile(r"^(?:unet\.)?(.+)\.lora_A\.weight$"), "down"),
    (re.compile(r"^(?:unet\.)?(.+)\.lora_B\.weight$"), "up"),
    # kohya: lora_unet_<underscored path>.lora_down / lora_up.weight, .alpha
    (re.compile(r"^(?:lora_unet_)?(.+)\.lora_down\.weight$"), "down"),
    (re.compile(r"^(?:lora_unet_)?(.+)\.lora_up\.weight$"), "up"),
    (re.compile(r"^(?:lora_unet_)?(.+)\.alpha$"), "alpha"),
)


def parse_lora_state_dict(sd: Mapping[str, np.ndarray]) -> Dict[str, dict]:
    """``{module path: {"down", "up"[, "alpha"]}}`` of a LoRA state dict's
    UNet entries (diffusers module paths, numpy arrays)."""
    pairs: Dict[str, dict] = {}
    for key, val in sd.items():
        if key.startswith(("text_encoder.", "lora_te_")):
            continue  # text-encoder LoRA: not merged here
        for pat, role in _PATTERNS:
            m = pat.match(key)
            if m:
                name = m.group(1)
                if key.startswith("lora_unet_"):
                    name = _repair_kohya_name(name)
                pairs.setdefault(name, {})[role] = np.asarray(val)
                break
    return pairs


def _delta(down: np.ndarray, up: np.ndarray, factor: float) -> np.ndarray:
    """``up @ down`` times ``factor`` in the target's layout: (out, in) for a
    2-D pair, (out, in, kh, kw) for a conv pair (up 1 x 1)."""
    if down.ndim == 2:
        return (up @ down) * factor
    return np.einsum("or,rikl->oikl", up.reshape(up.shape[0], -1), down) * factor


@torch.no_grad()
def merge_lora(unet: nn.Module, lora_sd: Mapping[str, np.ndarray], scale: float = 1.0) -> int:
    """Add each LoRA pair of ``lora_sd`` into ``unet``'s weights in place
    (``scale * alpha / rank``, alpha defaulting to the rank); returns the
    number of patched layers.  The product is formed in float32 on the host,
    as the JAX package forms it, then added in the weight's dtype; the
    in-place add moves each patched parameter's version, so cached int8
    weights of a patched conv are rebuilt."""
    params = dict(unet.named_parameters())
    patched = 0
    for name, parts in parse_lora_state_dict(lora_sd).items():
        if "down" not in parts or "up" not in parts:
            continue
        down, up = parts["down"], parts["up"]
        rank = down.shape[0]
        alpha = float(parts.get("alpha", rank))
        target = _torch_path_to_port(name) + ".weight"
        weight = params.get(target)
        if weight is None:
            logger.debug("lora target not found: %s -> %s", name, target)
            continue
        delta = _delta(down, up, alpha / rank * scale)
        if tuple(delta.shape) != tuple(weight.shape):
            logger.warning("lora shape mismatch at %s: %s vs %s", target, delta.shape, tuple(weight.shape))
            continue
        weight.add_(torch.from_numpy(np.ascontiguousarray(delta)).to(weight.device, weight.dtype))
        patched += 1
    if patched == 0:
        raise ValueError("no LoRA layers matched the UNet parameter tree")
    return patched


@torch.no_grad()
def load_textual_inversion(text_encoder: nn.Module, tokenizer, embedding: np.ndarray, token: str) -> list:
    """Append ``embedding``'s rows ((n_vectors, hidden) or (hidden,)) to
    ``text_encoder``'s token table and register ``token`` (and ``token_1``
    ... for more vectors) with ``tokenizer``; returns the new ids.  The table
    keeps its dtype and device; the encoder's config grows with it."""
    embedding = np.atleast_2d(np.asarray(embedding, np.float32))
    table = text_encoder.token_embedding.weight
    tokens = [token] + [f"{token}_{i}" for i in range(1, len(embedding))]
    new_ids = tokenizer.add_tokens(tokens)
    if new_ids[0] != table.shape[0]:
        raise ValueError("tokenizer/table id mismatch")
    rows = torch.from_numpy(embedding).to(table.device, table.dtype)
    grown = nn.Embedding(table.shape[0] + len(rows), table.shape[1], device=table.device, dtype=table.dtype)
    grown.weight.copy_(torch.cat([table, rows]))
    text_encoder.token_embedding = grown
    text_encoder.config = text_encoder.config.replace(vocab_size=grown.num_embeddings)
    return new_ids
