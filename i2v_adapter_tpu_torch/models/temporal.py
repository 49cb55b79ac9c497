"""AnimateDiff-style temporal motion module.

GroupNorm over (C, F*H*W) per clip -> linear proj_in -> transformer blocks
with double self-attention over the frame axis and interleaved sinusoidal
positions (capped at ``max_seq_length``) -> linear proj_out -> residual.
Activations stay (B, F, S, C) inside, as in the JAX package, and the frame
attention runs through ``ops.attention.temporal_attention``.  Over a mesh
whose ``seq`` axis splits the frames, the norm's sums are all-reduced over
``seq`` and the blocks run token-sharded where the tokens divide, else
frame-sharded with K/V gathered (``parallel.spmd``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from i2v_adapter_tpu_torch.models.attention import FeedForward
from i2v_adapter_tpu_torch.models.layers import GroupNorm, LayerNorm, Linear
from i2v_adapter_tpu_torch.ops.attention import temporal_attention
from i2v_adapter_tpu_torch.parallel.collectives import copy_to_parallel
from i2v_adapter_tpu_torch.parallel.spmd import (
    current_attention_spmd,
    motion_group_norm,
    motion_layout,
    motion_tokens_split,
    row_parallel_out,
    spmd_temporal_attention,
    temporal_frame_constraint,
    temporal_token_constraint,
)


def sinusoidal_positional_embedding(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """Interleaved sin/cos (diffusers ``SinusoidalPositionalEmbedding``)."""
    position = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / dim)
    )
    pe = torch.zeros(seq_len, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class TemporalSelfAttention(nn.Module):
    """Frame-axis multi-head attention on (B, F, S, C)."""

    def __init__(self, dim: int, heads: int, dim_head: int, attn_impl: str = "auto"):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.attn_impl = heads, dim_head, attn_impl
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = Linear(inner, dim)
        self.tp_group = None  # set over a mesh's tensor axis (parallel.spmd)

    def forward(self, x):
        def call(q, k, v, heads):
            return temporal_attention(q, k, v, heads=heads, impl=self.attn_impl)

        x = copy_to_parallel(x, self.tp_group)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        ctx = current_attention_spmd()
        out = call(q, k, v, self.heads) if ctx is None else spmd_temporal_attention(call, q, k, v, self.heads, ctx)
        return row_parallel_out(self.to_out, out, self.tp_group)


class TemporalBlock(nn.Module):
    """Two self-attentions (positions added after norm1 and norm2 only) and a
    GEGLU feed-forward, each residual.  Input (B, F, S, C)."""

    def __init__(self, dim: int, heads: int, dim_head: int, max_seq_length: int = 32,
                 norm_eps: float = 1e-5, gelu_tanh: bool = False, attn_impl: str = "auto"):
        super().__init__()
        self.max_seq_length = max_seq_length
        self.norm1 = LayerNorm(dim, eps=norm_eps)
        self.attn1 = TemporalSelfAttention(dim, heads, dim_head, attn_impl)
        self.norm2 = LayerNorm(dim, eps=norm_eps)
        self.attn2 = TemporalSelfAttention(dim, heads, dim_head, attn_impl)
        self.norm3 = LayerNorm(dim, eps=norm_eps)
        self.ff = FeedForward(dim, gelu_tanh=gelu_tanh)

    def forward(self, x, frame_offset: int = 0, total_frames: int = 0):
        """``frame_offset`` / ``total_frames``: where this rank's frames sit
        in the clip when the frames are split over a mesh (positions are the
        clip's)."""
        f = x.shape[1]
        total = total_frames or f
        if total > self.max_seq_length:
            raise ValueError(
                f"num_frames {total} exceeds motion positional-embedding cap {self.max_seq_length}"
            )
        pe = sinusoidal_positional_embedding(frame_offset + f, x.shape[-1], x.device)[frame_offset:]
        pe = pe.to(x.dtype)[None, :, None, :]
        x = x + self.attn1(self.norm1(x) + pe)
        x = x + self.attn2(self.norm2(x) + pe)
        return x + self.ff(self.norm3(x))


class TemporalTransformer(nn.Module):
    """Motion module applied to (B*F, H, W, C) activations."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, num_layers: int = 1,
                 max_seq_length: int = 32, groups: int = 32, attn_impl: str = "auto",
                 gelu_tanh: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.num_layers = num_layers
        self.norm = GroupNorm(groups, in_channels, 1e-6)
        self.proj_in = Linear(in_channels, inner)
        for i in range(num_layers):
            self.add_module(f"transformer_blocks_{i}", TemporalBlock(
                inner, heads, dim_head, max_seq_length=max_seq_length,
                gelu_tanh=gelu_tanh, attn_impl=attn_impl,
            ))
        self.proj_out = Linear(inner, in_channels)

    def forward(self, x, *, num_frames: int):
        bf, h, w, c = x.shape
        if bf % num_frames != 0:
            raise ValueError(f"batch {bf} not divisible by frames {num_frames}")
        b = bf // num_frames
        residual = x
        ctx = current_attention_spmd()
        # GroupNorm jointly over (F, H, W) per clip: the norm couples frames
        flat = x.reshape(b, num_frames * h * w, c)
        if ctx is None or ctx.seq_size == 1:
            tokens = self.norm(flat)
        else:
            tokens = motion_group_norm(flat, self.norm.num_groups, self.norm.eps, self.norm.weight,
                                       self.norm.bias)
        tokens = tokens.reshape(b, num_frames, h * w, c)
        if ctx is None:
            return self._blocks(tokens).reshape(bf, h, w, c) + residual
        split = motion_tokens_split(ctx, h * w)
        with motion_layout(ctx, split):
            if split:  # every frame local, a block of the tokens
                tokens = temporal_frame_constraint(self._blocks(temporal_token_constraint(tokens)))
            else:
                tokens = self._blocks(tokens, ctx.frame_offset, ctx.frames)
        return tokens.reshape(bf, h, w, c) + residual

    def _blocks(self, tokens, frame_offset: int = 0, total_frames: int = 0):
        tokens = self.proj_in(tokens)
        for i in range(self.num_layers):
            tokens = getattr(self, f"transformer_blocks_{i}")(tokens, frame_offset, total_frames)
        return self.proj_out(tokens)
