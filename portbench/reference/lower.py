"""The reference's precisions below float32.

``Int8Sites`` is the serving configuration's own: its resnet, down- and
upsample convs and the VAE decoder's convs run in int8, as the program
quantises them (activations by one scale per call, ``max |x| / 127`` over
the whole tensor, so over every frame and both CFG halves of the call;
weights per output channel, ``max |w| / 127``; round half to even), and
every other operand is exact.  The reference works these int8 operands out
again from the same weights and its own activations; it takes none of the
program's scales or quantised weights.

``Lowered`` is the control's: one step below what the configuration states.
It rounds the operands of the int8 sites to int4 (7 levels a side, scaled
as above) and the operands of every other matmul, convolution and attention
product to float8 e4m3 (one scale per tensor, its largest magnitude mapped
to 448), computing in float32.  Under autograd the rounding is passed
through: the forward is lowered, the gradients are float32.  Training has
no int8 site, so its control is float8 throughout."""

from __future__ import annotations

import torch

from portbench.reference.model import Precision

FP8_MAX = 448.0
INT4_MAX = 7.0
INT8_MAX = 127.0


def _fp8(x: torch.Tensor, dims=None) -> torch.Tensor:
    amax = x.abs().amax() if dims is None else x.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp_min(amax.float(), 1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _int(x: torch.Tensor, levels: float, dims=None) -> torch.Tensor:
    """``x`` on a symmetric integer grid of ``levels`` a side, one scale per
    tensor or per slice over ``dims``."""
    amax = x.abs().amax() if dims is None else x.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp_min(amax.float(), 1e-12) / levels
    return torch.clamp(torch.round(x / scale), -levels, levels) * scale


def _through(x: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """``low`` forward, the identity backward (gradients stay float32)."""
    return x + (low - x).detach()


def _per_out_channel(w: torch.Tensor):
    return tuple(range(1, w.ndim))


class Int8Sites(Precision):
    def act(self, x, kind):
        return _int(x, INT8_MAX) if kind == "int" else x

    def weight(self, w, kind):
        return _int(w, INT8_MAX, _per_out_channel(w)) if kind == "int" else w


class Lowered(Precision):
    def act(self, x, kind):
        return _through(x, _int(x, INT4_MAX) if kind == "int" else _fp8(x))

    def weight(self, w, kind):
        return _through(w, _int(w, INT4_MAX, _per_out_channel(w)) if kind == "int" else _fp8(w))
