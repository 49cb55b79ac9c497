"""CLIP text and vision encoders: pre-LN transformers with plain matmul
attention (fp32 softmax), causal masking for text, class-token pooling and
a linear projection for vision."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from i2v_adapter_tpu_torch.config import CLIPTextConfig, CLIPVisionConfig
from i2v_adapter_tpu_torch.device import DeviceLike, resolve_device
from i2v_adapter_tpu_torch.models.layers import ConvNHWC, LayerNorm, Linear


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


_ACTS = {"quick_gelu": quick_gelu, "gelu": lambda x: F.gelu(x, approximate="none")}


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(hidden, hidden)
        self.k_proj = Linear(hidden, hidden)
        self.v_proj = Linear(hidden, hidden)
        self.out_proj = Linear(hidden, hidden)

    def forward(self, x, mask=None):
        b, n, c = x.shape
        d = c // self.heads
        q = self.q_proj(x).view(b, n, self.heads, d)
        k = self.k_proj(x).view(b, n, self.heads, d)
        v = self.v_proj(x).view(b, n, self.heads, d)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
        return self.out_proj(out.reshape(b, n, c))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, act: str):
        super().__init__()
        self.act = _ACTS[act]
        self.fc1 = Linear(hidden, intermediate)
        self.fc2 = Linear(intermediate, hidden)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int, act: str, eps: float):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden, eps=eps)
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm2 = LayerNorm(hidden, eps=eps)
        self.mlp = CLIPMLP(hidden, intermediate, act)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


def _layers(cfg) -> list:
    return [
        CLIPEncoderLayer(cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
                         cfg.hidden_act, cfg.layer_norm_eps)
        for _ in range(cfg.num_hidden_layers)
    ]


class CLIPTextEncoder(nn.Module):
    """input_ids (B, L) -> final-LayerNorm hidden states (B, L, C).
    ``clip_skip`` > 0 stops that many layers early (still final-LN'd)."""

    def __init__(self, config: CLIPTextConfig, device: DeviceLike = None):
        super().__init__()
        self.config = cfg = config
        with torch.device(resolve_device(device)):
            self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.position_embedding = nn.Parameter(
                torch.zeros(cfg.max_position_embeddings, cfg.hidden_size)
            )
            for i, layer in enumerate(_layers(cfg)):
                self.add_module(f"layers_{i}", layer)
            self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, clip_skip: int = 0, dtype: Optional[torch.dtype] = None):
        """``dtype`` is the compute dtype (default: the embeddings' storage
        dtype)."""
        cfg = self.config
        n = input_ids.shape[1]
        x = self.token_embedding(input_ids.long()) + self.position_embedding[None, :n]
        x = x.to(dtype or x.dtype)
        mask = torch.triu(
            torch.full((n, n), -1e9, dtype=torch.float32, device=x.device), diagonal=1
        )[None, None]
        for i in range(cfg.num_hidden_layers - clip_skip):
            x = getattr(self, f"layers_{i}")(x, mask)
        return self.final_layer_norm(x)


class CLIPVisionEncoder(nn.Module):
    """pixel_values (B, H, W, 3), CLIP-normalised -> projected image
    embedding (B, projection_dim), the IP-Adapter standard head's input."""

    def __init__(self, config: CLIPVisionConfig, device: DeviceLike = None):
        super().__init__()
        self.config = cfg = config
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        with torch.device(resolve_device(device)):
            self.patch_embedding = ConvNHWC(
                3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size, bias=False
            )
            self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
            self.position_embedding = nn.Parameter(torch.zeros(n_patches + 1, cfg.hidden_size))
            self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
            for i, layer in enumerate(_layers(cfg)):
                self.add_module(f"layers_{i}", layer)
            self.post_layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
            self.visual_projection = Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, pixel_values, dtype: Optional[torch.dtype] = None):
        """``dtype`` is the compute dtype (default: the storage dtype)."""
        cfg = self.config
        dtype = dtype or self.class_embedding.dtype
        patches = self.patch_embedding(pixel_values.to(dtype))
        b = patches.shape[0]
        patches = patches.reshape(b, -1, cfg.hidden_size)
        cls = self.class_embedding.to(dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, patches], dim=1) + self.position_embedding[None].to(dtype)
        x = self.pre_layrnorm(x)
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layers_{i}")(x)
        return self.visual_projection(self.post_layernorm(x[:, 0]))
