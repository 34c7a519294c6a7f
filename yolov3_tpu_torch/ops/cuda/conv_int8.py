"""K6 — the int8 k×k conv with the requant epilogue: CUDA kernel + plain version.

The JAX package has no Pallas source for this one: it leaves the int8 3×3
and strided convs to XLA's convolution (``yolov3_tpu/models/layers.py``,
``conv2d_int8``, the ``lax.conv_general_dilated`` branch). PyTorch has no
int8 convolution on CUDA, so the port carries a kernel of its own
(``csrc/conv_int8.cu``), an implicit GEMM over NHWC:

    acc[b,oh,ow,co] = Σ_{dy,dx,ci} xq[b, oh·s − top + dy, ow·s − left + dx, ci]
                                   · kq[co, dy, dx, ci]          (zero outside)

followed by K3's epilogue (scale, bias, leaky, requant or f32). It takes any
square kernel, stride, asymmetric padding and channel count — the Darknet
3×3 stride-1/2 convs and both convs of the space-to-depth stem (4×4 stride 2
with Cin = 3, 2×2 stride 1).

Two paths, chosen from the shape alone (``plan`` mirrors the choice that
``conv_int8_launch`` makes):

* ``Cin % 16 == 0``: 128 × (64 | 128) output tiles on Hopper's ``wgmma``
  (s8 × s8 → s32), both operands gathered by 16-byte ``cp.async`` copies into
  a three-stage swizzled ring in shared memory, the epilogue staged through
  shared memory and stored 16 bytes a thread. A grid too small for the card
  (batch 1 and 4 at 13² and 26²) splits the contraction over the blocks of a
  cluster, which add their exact s32 sums before the one epilogue.
* otherwise (the image's Cin = 3): a byte-by-byte gather and ``mma.sync``.

Both are bit-equal to ``conv_int8_plain``: integer sums, one epilogue. The
kernel is reached only through the ``yolov3_torch::conv_int8`` op (CPU
kernel: the plain version; see ``nms_kernel.py``), which makes its operands
contiguous.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from .conv1x1 import check_epilogue_args
from .requant import conv_epilogue


def out_size(size: int, k: int, stride: int, pads) -> int:
    return (size + pads[0] + pads[1] - k) // stride + 1


_BM, _BK, _MAX_SPLIT, _BLOCK_SLOTS = 128, 128, 8, 264


def plan(m: int, cin: int, cout: int, k: int):
    """What ``conv_int8_launch`` picks for an (M = B·Ho·Wo) × (K = kh·kw·Cin) ×
    Cout product: ``dict(path, tile=(BM, BN), grid=(m_tiles, n_tiles, split))``.
    ``path`` is "wgmma" when ``cin % 16 == 0``, else "mma.sync" (the byte
    gather); ``split`` is the number of blocks that share one tile's
    contraction (1 on the byte path)."""
    if cin % 16 == 0:
        bn = 128 if cout > 64 else 64
        mt, nt, kt = -(-m // _BM), -(-cout // bn), -(-k // _BK)
        split = 1
        while split < _MAX_SPLIT and mt * nt * split * 2 <= _BLOCK_SLOTS and kt >= split * 4:
            split *= 2
        return dict(path="wgmma", tile=(_BM, bn), grid=(mt, nt, split))
    bn = 128 if cout > 64 else 64 if cout > 32 else 32
    return dict(path="mma.sync", tile=(_BM, bn), grid=(-(-m // _BM), -(-cout // bn), 1))


def conv_int8_plain(xq, kq, scale, bias, inv_out_scale, *, stride: int, padding,
                    leaky: bool, out_dtype=torch.int8):
    """Plain PyTorch version, exact on the CPU and on the card: a float64
    convolution of the int8 values (sums ≤ 16·1024·127² are exact there;
    ``round`` takes off what a transform-based algorithm might add), rounded
    to float32 once, then the epilogue in the kernel's order."""
    (top, bottom), (left, right) = padding
    x = F.pad(xq.permute(0, 3, 1, 2).to(torch.float64), (left, right, top, bottom))
    acc = F.conv2d(x, kq.permute(0, 3, 1, 2).to(torch.float64), stride=stride)
    acc = acc.round().permute(0, 2, 3, 1).to(torch.float32)
    return conv_epilogue(acc, scale, bias, inv_out_scale, leaky, out_dtype)


def conv_int8(xq, kq, scale, bias, inv_out_scale, *, stride: int, padding, leaky: bool,
              out_dtype=torch.int8):
    """xq (B, H, W, Cin) int8 NHWC, kq (Cout, kh, kw, Cin) int8, scale/bias
    (Cout,) f32, inv_out_scale a one-element f32 tensor (unused when
    ``out_dtype`` is float32), ``padding`` ((top, bottom), (left, right)) →
    (B, Ho, Wo, Cout) ``out_dtype``, through the ``yolov3_torch::conv_int8``
    op: CPU tensors take the plain version; CUDA tensors launch
    ``conv_int8_wgmma_kernel`` or ``conv_int8_bytes_kernel`` (see ``plan``;
    counted in ``conv_int8.launches``) or raise."""
    (top, bottom), (left, right) = padding
    return torch.ops.yolov3_torch.conv_int8.default(
        xq, kq, scale, bias, inv_out_scale, int(stride), [top, bottom, left, right],
        bool(leaky), out_dtype)


conv_int8.launches = 0


@torch.library.custom_op("yolov3_torch::conv_int8", mutates_args=(), device_types="cpu")
def _conv_int8_op(xq: torch.Tensor, kq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  inv_out_scale: torch.Tensor | None, stride: int, pads: list[int],
                  leaky: bool, out_dtype: torch.dtype) -> torch.Tensor:
    return conv_int8_plain(xq, kq, scale, bias, inv_out_scale, stride=stride,
                           padding=(pads[:2], pads[2:]), leaky=leaky, out_dtype=out_dtype)


@_conv_int8_op.register_kernel("cuda")
def _conv_int8_cuda(xq, kq, scale, bias, inv_out_scale, stride, pads, leaky, out_dtype):
    if xq.dim() != 4 or kq.dim() != 4 or xq.shape[3] != kq.shape[3]:
        raise ValueError(f"conv_int8: shapes {tuple(xq.shape)}, {tuple(kq.shape)}")
    if xq.dtype != torch.int8 or kq.dtype != torch.int8 or kq.device != xq.device:
        raise ValueError(f"conv_int8: needs int8 on one device, got {xq.dtype}, {kq.dtype}")
    # a loaded program's strides need not be the trace's (``nms_kernel.py``)
    xq, kq = xq.contiguous(), kq.contiguous()
    b, h, w, cin = xq.shape
    cout, kh, kw, _ = kq.shape
    top, bottom, left, right = pads
    ho, wo = out_size(h, kh, stride, (top, bottom)), out_size(w, kw, stride, (left, right))
    if ho <= 0 or wo <= 0 or b * ho * wo >= 2 ** 31 or xq.numel() >= 2 ** 31:
        raise ValueError(f"conv_int8: output {b}×{ho}×{wo} out of range")
    inv_ptr = check_epilogue_args("conv_int8", xq, cout, scale, bias, inv_out_scale,
                                  out_dtype)
    if cin % 16 == 0 and (xq.data_ptr() % 16 or kq.data_ptr() % 16):
        raise ValueError("conv_int8: xq and kq must be 16-byte aligned when Cin % 16 == 0")
    out = torch.empty((b, ho, wo, cout), dtype=out_dtype, device=xq.device)
    flags = int(bool(leaky)) | (int(out_dtype == torch.float32) << 1)
    build.launch(build.function("conv_int8", "conv_int8_launch"), xq.device, "conv_int8",
                 xq.data_ptr(), kq.data_ptr(), scale.data_ptr(), bias.data_ptr(), inv_ptr,
                 out.data_ptr(), b, h, w, cin, cout, kh, kw, stride, top, left, ho, wo, flags)
    conv_int8.launches += 1
    return out


@_conv_int8_op.register_fake
def _conv_int8_fake(xq, kq, scale, bias, inv_out_scale, stride, pads, leaky, out_dtype):
    b, h, w, _ = xq.shape
    cout, kh, kw, _ = kq.shape
    return xq.new_empty((b, out_size(h, kh, stride, pads[:2]), out_size(w, kw, stride, pads[2:]),
                         cout), dtype=out_dtype)
