"""The controls: the reference computed one precision below what a cell
states, which the comparison has to reject.

  * below bfloat16: float8. Every convolution's input is rounded to e4m3
    at one scale for the tensor (its abs-max over 448) and its weight at
    one scale an output channel; in a training step the gradient that
    reaches a convolution's output, input or weight is rounded to e5m2 at
    one scale for the tensor (its abs-max over 57,344), as float8 training
    recipes keep gradients; products are summed in float32;
  * below int8: int4, the int8 tier's lattice at ±7 (``int8.py``).
"""

from __future__ import annotations

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0
INT4_LATTICE = 7


def _round(x, dtype, top, absmax):
    scale = torch.clamp(absmax, min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Forward8(torch.autograd.Function):
    """e4m3 on the way forward, e5m2 on the way back."""

    @staticmethod
    def forward(ctx, x, absmax):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX, absmax)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX, g.abs().amax()), None


class _Backward8(torch.autograd.Function):
    """The identity on the way forward, e5m2 on the way back."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX, g.abs().amax())


class Float8Rounding:
    def activation(self, x):
        return _Forward8.apply(x, x.detach().abs().amax())

    def weight(self, w):
        return _Forward8.apply(w, w.detach().abs().amax(dim=(1, 2, 3), keepdim=True))

    def output(self, y):
        return _Backward8.apply(y)
