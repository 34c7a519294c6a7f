"""Primitive layer ops — plain PyTorch functions on NCHW tensors (fp path).

Counterpart of ``yolov3_tpu/models/layers.py``; the semantics are the
reference's Keras layer stack (core/parse_model.py:13-213):

  * convolutional: Darknet padding — 'SAME' for stride 1 (``p=(k-1)//2``
    before, ``k-1-p`` after), explicit ((1,0),(1,0)) zero-pad + VALID for
    stride 2; bias only when no BN; LeakyReLU(0.1).
  * batch norm (inference): Keras eps 1e-3, ``(x-mean)·gamma·rsqrt(var+eps)+beta``.
  * upsample: nearest-neighbour ×stride.
  * maxpool: Keras MaxPooling2D; 'same' pads are the asymmetric TF ones
    (``_pool_same_pads``: tiny's 2×2 stride-1 pool pads (0, 1)).

Kernels are OIHW (PyTorch's layout); ``models/convert.py`` moves the JAX
package's HWIO kernels across. The int8 tier is a later slice of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
LEAKY_SLOPE = 0.1


def conv_padding(ksize: int, stride: int, pad: int, explicit_pad=None):
    """((top, bottom), (left, right)) zero padding of a Darknet conv."""
    if explicit_pad is not None:
        return tuple(tuple(p) for p in explicit_pad)
    if stride > 1:
        return (1, 0), (1, 0)  # ZeroPadding2D(((1, 0), (1, 0))) + VALID
    if pad == 1:
        p = (ksize - 1) // 2
        return (p, ksize - 1 - p), (p, ksize - 1 - p)
    return (0, 0), (0, 0)


def conv2d(x, kernel, stride: int, pad: int, explicit_pad=None):
    """Darknet-style conv. x: (B, C, H, W); kernel: (cout, cin, kh, kw)."""
    (top, bottom), (left, right) = conv_padding(kernel.shape[2], stride, pad,
                                                explicit_pad)
    if top == bottom and left == right:
        return F.conv2d(x, kernel.to(x.dtype), stride=stride, padding=(top, left))
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, kernel.to(x.dtype), stride=stride)


def batch_norm(x, bn_params, bn_state, eps=BN_EPS):
    """Inference-mode BatchNorm over channel axis 1 with running statistics."""
    scale = bn_params["gamma"] * torch.rsqrt(bn_state["var"] + eps)
    shape = (1, -1, 1, 1)
    return ((x - bn_state["mean"].to(x.dtype).view(shape))
            * scale.to(x.dtype).view(shape) + bn_params["beta"].to(x.dtype).view(shape))


def leaky_relu(x, slope=LEAKY_SLOPE):
    return torch.where(x >= 0, x, x * slope)


def upsample_nearest(x, stride: int):
    return x.repeat_interleave(stride, dim=2).repeat_interleave(stride, dim=3)


def _pool_same_pads(hw, size_xy, stride_xy):
    pads = []
    for dim, k, s in zip(hw, size_xy, stride_xy):
        out = -(-dim // s)  # ceil
        total = max((out - 1) * s + k - dim, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def max_pool(x, size_xy, stride_xy, padding: str):
    if padding.lower() == "same":
        (top, bottom), (left, right) = _pool_same_pads(x.shape[2:4], size_xy, stride_xy)
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, tuple(size_xy), tuple(stride_xy))


def glorot_uniform(generator, shape, dtype=torch.float32):
    """Keras Conv2D default kernel init (glorot_uniform), OIHW ``shape``,
    drawn on the CPU from ``generator`` so a seed gives the same weights on
    every device."""
    cout, cin, kh, kw = shape
    limit = (6.0 / (kh * kw * cin + kh * kw * cout)) ** 0.5
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return u * (2 * limit) - limit
