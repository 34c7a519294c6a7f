"""K0 — the shared int8 epilogue, plain PyTorch version.

Counterpart of ``yolov3_tpu/ops/pallas/common.py`` (``leaky``,
``requant_clip``) and of the device header ``csrc/requant.cuh`` that the int8
kernels (K3, K4, K6) include: one definition of the requant contract —
LeakyReLU slope 0.1, round half to even, clip to the symmetric int8 range
[-127, 127] — for the kernels' plain versions and for the unfused ops of
``models/layers.py``. Every step is its own element-wise torch op, so each
product and sum is rounded once, as the kernels' ``__fmul_rn`` /
``__fadd_rn`` are.
"""

from __future__ import annotations

import torch

LEAKY_SLOPE = 0.1


def leaky(y):
    """LeakyReLU(0.1) on f32 values."""
    return torch.where(y >= 0, y, y * LEAKY_SLOPE)


def requant_clip(y, inv_scale):
    """f32 → the symmetric int8 lattice (round half to even, clip ±127), as
    f32; callers cast to int8 where the value leaves the computation."""
    return torch.clamp(torch.round(y * inv_scale), -127, 127)


def conv_epilogue(acc32, scale, bias, inv_out_scale, leaky_on: bool, out_dtype):
    """The conv epilogue of K3 and K6 in the kernels' order. ``acc32``: the
    exact integer sums as float32 (…, Cout); ``scale``/``bias`` per channel;
    int8 output requantizes with ``inv_out_scale``, f32 output returns y."""
    y = acc32 * scale + bias
    if leaky_on:
        y = leaky(y)
    if out_dtype == torch.int8:
        return requant_clip(y, inv_out_scale).to(torch.int8)
    return y.to(out_dtype)
