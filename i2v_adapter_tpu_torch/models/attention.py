"""Attention modules: projections in PyTorch, attention math in ops.attention.

Per spatial transformer block (the JAX ``models/attention.py``):

* ``attn1``       -- spatial self-attention over each frame's tokens
* ``i2v_adapter`` -- cross-frame attention: queries from every frame, K/V
  from the clip's first frame (``kv_repeat = num_frames``, no broadcast
  copy), output added to attn1's
* ``attn2``       -- text cross-attention plus the IP-Adapter branch
  (separate K/V over the trailing image tokens, scale-added)
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from i2v_adapter_tpu_torch.models.layers import ConvNHWC, GroupNorm, LayerNorm, Linear
from i2v_adapter_tpu_torch.ops.attention import dot_product_attention
from i2v_adapter_tpu_torch.parallel.spmd import (
    current_attention_spmd,
    first_frame_constraint,
    row_parallel_out,
    spmd_flash_attention,
)


class Attention(nn.Module):
    """Multi-head attention with the diffusers projection layout (to_q/to_k/
    to_v without bias, to_out with bias).  Over a mesh's ``tensor`` axis the
    projections hold this rank's heads and ``tp_group`` is set
    (``parallel.spmd.shard_tensor_parallel``)."""

    def __init__(
        self,
        query_dim: int,
        heads: int,
        dim_head: int,
        context_dim: int = None,
        attn_impl: str = "auto",
        static_max: float = 0.0,
        ip_num_tokens: int = 0,
        ip_scale: float = 1.0,
    ):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.attn_impl, self.static_max = attn_impl, static_max
        self.ip_num_tokens, self.ip_scale = ip_num_tokens, ip_scale
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        if ip_num_tokens > 0:
            self.to_k_ip = Linear(context_dim, inner, bias=False)
            self.to_v_ip = Linear(context_dim, inner, bias=False)
        self.to_out = Linear(inner, query_dim)
        self.tp_group = None

    def _attend(self, q, k, v, kv_repeat):
        split = lambda x: x.view(x.shape[0], x.shape[1], self.heads, self.dim_head)

        def call(q, k, v, kv_repeat):
            return dot_product_attention(q, k, v, kv_repeat=kv_repeat, impl=self.attn_impl,
                                         static_max=self.static_max)

        ctx = current_attention_spmd()
        if ctx is None:
            out = call(split(q), split(k), split(v), kv_repeat)
        else:
            out = spmd_flash_attention(call, split(q), split(k), split(v), kv_repeat, ctx)
        return out.view(q.shape)

    def forward(self, hidden_states, encoder_hidden_states=None, kv_repeat: int = 1):
        ctx = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        if self.ip_num_tokens > 0:
            n_text = ctx.shape[1] - self.ip_num_tokens
            text_ctx, ip_ctx = ctx[:, :n_text], ctx[:, n_text:]
        else:
            text_ctx, ip_ctx = ctx, None
        q = self.to_q(hidden_states)
        out = self._attend(q, self.to_k(text_ctx), self.to_v(text_ctx), kv_repeat)
        if ip_ctx is not None:
            ip_out = self._attend(q, self.to_k_ip(ip_ctx), self.to_v_ip(ip_ctx), kv_repeat)
            out = out + self.ip_scale * ip_out
        return row_parallel_out(self.to_out, out, self.tp_group)


class FeedForward(nn.Module):
    """GEGLU feed-forward; ``gelu_tanh`` selects the tanh approximation."""

    def __init__(self, dim: int, mult: int = 4, gelu_tanh: bool = False):
        super().__init__()
        inner = dim * mult
        self.gelu_tanh = gelu_tanh
        self.proj = Linear(dim, inner * 2)
        self.proj_out = Linear(inner, dim)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        h = h * F.gelu(gate, approximate="tanh" if self.gelu_tanh else "none")
        return self.proj_out(h)


class TransformerBlock(nn.Module):
    """Spatial transformer block with the I2V-Adapter cross-frame attention:
    norm1 -> attn1 (+ adapter), norm2 -> attn2, norm3 -> FF, each residual."""

    def __init__(
        self,
        dim: int,
        heads: int,
        dim_head: int,
        context_dim: int,
        use_i2v_adapter: bool = True,
        ip_num_tokens: int = 0,
        ip_scale: float = 1.0,
        norm_eps: float = 1e-5,
        attn_impl: str = "auto",
        static_max: float = 0.0,
        gelu_tanh: bool = False,
    ):
        super().__init__()
        kw = dict(heads=heads, dim_head=dim_head, attn_impl=attn_impl, static_max=static_max)
        self.norm1 = LayerNorm(dim, eps=norm_eps)
        self.attn1 = Attention(dim, **kw)
        self.use_i2v_adapter = use_i2v_adapter
        if use_i2v_adapter:
            self.i2v_adapter = Attention(dim, **kw)
        self.norm2 = LayerNorm(dim, eps=norm_eps)
        self.attn2 = Attention(
            dim, context_dim=context_dim, ip_num_tokens=ip_num_tokens, ip_scale=ip_scale, **kw
        )
        self.norm3 = LayerNorm(dim, eps=norm_eps)
        self.ff = FeedForward(dim, gelu_tanh=gelu_tanh)

    def forward(self, hidden_states, encoder_hidden_states, *,
                enable_cross_frame_attn: bool = False, num_frames: int = 1):
        norm_h = self.norm1(hidden_states)
        attn_out = self.attn1(norm_h)
        if self.use_i2v_adapter and enable_cross_frame_attn:
            bf = hidden_states.shape[0]
            if bf % num_frames != 0:
                raise ValueError(f"batch {bf} not divisible by frames {num_frames}")
            # over a mesh num_frames is this rank's; frame 0 comes from the
            # seq rank that holds it, and the repeat passed is the clip's
            ctx = current_attention_spmd()
            first_frame = first_frame_constraint(
                norm_h.view(bf // num_frames, num_frames, *norm_h.shape[1:])[:, 0])
            attn_out = attn_out + self.i2v_adapter(
                norm_h, encoder_hidden_states=first_frame,
                kv_repeat=num_frames * (1 if ctx is None else ctx.seq_size),
            )
        hidden_states = hidden_states + attn_out
        hidden_states = hidden_states + self.attn2(
            self.norm2(hidden_states), encoder_hidden_states=encoder_hidden_states
        )
        return hidden_states + self.ff(self.norm3(hidden_states))


class SpatialTransformer(nn.Module):
    """Transformer2DModel equivalent hosting TransformerBlocks; channel-last
    (N, H, W, C) in and out, 1x1-conv (or linear) proj_in / proj_out."""

    def __init__(
        self,
        in_channels: int,
        heads: int,
        dim_head: int,
        context_dim: int,
        num_layers: int = 1,
        use_linear_projection: bool = False,
        use_i2v_adapter: bool = True,
        ip_num_tokens: int = 0,
        ip_scale: float = 1.0,
        groups: int = 32,
        attn_impl: str = "auto",
        static_max: float = 0.0,
        gelu_tanh: bool = False,
    ):
        super().__init__()
        inner = heads * dim_head
        self.num_layers = num_layers
        self.norm = GroupNorm(groups, in_channels, 1e-6)
        if use_linear_projection:
            self.proj_in = Linear(in_channels, inner)
            self.proj_out = Linear(inner, in_channels)
        else:
            self.proj_in = ConvNHWC(in_channels, inner, 1)
            self.proj_out = ConvNHWC(inner, in_channels, 1)
        for i in range(num_layers):
            self.add_module(f"transformer_blocks_{i}", TransformerBlock(
                inner, heads, dim_head, context_dim, use_i2v_adapter=use_i2v_adapter,
                ip_num_tokens=ip_num_tokens, ip_scale=ip_scale, attn_impl=attn_impl,
                static_max=static_max, gelu_tanh=gelu_tanh,
            ))

    def forward(self, x, encoder_hidden_states, *,
                enable_cross_frame_attn: bool = False, num_frames: int = 1):
        b, h, w, c = x.shape
        residual = x
        x = self.proj_in(self.norm(x)).reshape(b, h * w, -1)
        for i in range(self.num_layers):
            x = getattr(self, f"transformer_blocks_{i}")(
                x, encoder_hidden_states,
                enable_cross_frame_attn=enable_cross_frame_attn, num_frames=num_frames,
            )
        x = self.proj_out(x.reshape(b, h, w, -1))
        return x + residual
