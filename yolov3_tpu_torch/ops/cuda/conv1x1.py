"""K3 — the fused int8 1×1 conv: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``yolov3_tpu/ops/pallas/conv1x1.py``
(``conv1x1_int8_requant``):

    acc = xq @ wqᵀ                       s8 × s8 → s32, exact
    y   = f32(acc) · scale + bias        two roundings, per output channel
    y   = leaky(y)                       optional, slope 0.1
    out = int8(clip(rint(y · inv), ±127))    or y itself when out is f32

xq (M, Cin) int8 is the NHWC activation seen as a matrix; wq is the port's
packed weight (Cout, Cin) int8 — one row per output channel, the
contraction contiguous (the JAX kernel takes the transpose, (Cin, Cout)).
The TPU kernel's row-tile picking and channel gates were VMEM and lane
facts; here every int8 1×1 stride-1 conv takes this kernel, any M, Cin and
Cout (ragged edges are masked in the kernel).

Three paths, chosen from the shape alone (``plan`` mirrors the choice that
``conv1x1_int8_launch`` makes; ``csrc/conv1x1_int8.cu`` says what bounds
each):

* ``Cin % 16 == 0``, ``Cin ≤ 128`` and ``Cout ≤ 128`` — "persistent": up to
  four blocks an SM walk the 128-row M-tiles with the weight tile resident
  in shared memory and the next tiles' activations in flight, on ``wgmma``
  (m64n{32,64,128}k32 by Cout);
* ``Cin % 16 == 0`` otherwise — "wgmma": 128 × 64 tiles (128 × 32 where
  those would not fill the card's 264 block slots) on the three-stage
  ``cp.async`` ring of ``csrc/int8_wgmma.cuh``;
* otherwise — "mma.sync": one shared-memory stage and ``mma.sync``.

All three are bit-equal to ``conv1x1_int8_requant_plain``. The kernel is
reached only through the ``yolov3_torch::conv1x1_int8_requant`` op (CPU
kernel: the plain version; see ``nms_kernel.py``), which makes its operands
contiguous.
"""

from __future__ import annotations

import torch

from . import build
from .requant import conv_epilogue


_BM, _BK, _SMS = 128, 128, 132
_SMEM_PER_SM, _BLOCK_RESERVE = 233472, 2048  # an SM's shared memory; 1 KB a block + 1 KB spare
_MAX_BLOCKS = {32: 4, 64: 3, 128: 2}          # persistent blocks an SM by registers, by BN


def _persistent_smem(bn: int, stages: int, out_f32: bool) -> int:
    return bn * _BK + stages * _BM * _BK + _BM * (bn + 16) * (4 if out_f32 else 1) + 1024


def plan(m: int, cin: int, cout: int, out_dtype=torch.int8):
    """What ``conv1x1_int8_launch`` picks for an (M × Cin) · (Cin × Cout)
    product: ``dict(path, tile=(BM, BN), grid=(x, y, z))``. For "wgmma" and
    "mma.sync" the grid is (m_tiles, n_tiles, 1), a block a tile; for
    "persistent" it is (blocks, 1, 1), each block walking the M-tiles
    ``blockIdx.x + i·blocks``, with ``per_sm`` (blocks an SM) and ``stages``
    (the activation ring's depth) beside it."""
    mt = -(-m // _BM)
    if cin % 16:
        bn = 128 if cout > 64 else 64 if cout > 32 else 32
        return dict(path="mma.sync", tile=(_BM, bn), grid=(mt, -(-cout // bn), 1))
    if cin <= _BK and cout <= 128:
        bn = 128 if cout > 64 else 64 if cout > 32 else 32
        f32 = out_dtype == torch.float32
        stages, per_sm = next(((s, p) for p in range(_MAX_BLOCKS[bn], 1, -1) for s in (4, 3, 2)
                               if p * (_persistent_smem(bn, s, f32) + _BLOCK_RESERVE)
                               <= _SMEM_PER_SM), (4, 1))
        return dict(path="persistent", tile=(_BM, bn), grid=(min(mt, per_sm * _SMS), 1, 1),
                    stages=stages, per_sm=per_sm)
    bn = 64 if mt * -(-cout // 64) >= 2 * _SMS else 32
    return dict(path="wgmma", tile=(_BM, bn), grid=(mt, -(-cout // bn), 1))


def conv1x1_int8_requant_plain(xq, wq, scale, bias, inv_out_scale, *, leaky: bool,
                               out_dtype=torch.int8):
    """Plain PyTorch version, exact on the CPU and on the card: the product
    runs in float64 (sums ≤ Cin·127² are exact there) and is rounded to
    float32 once, as the kernel's ``__int2float_rn`` does."""
    acc = (xq.to(torch.float64) @ wq.to(torch.float64).t()).to(torch.float32)
    return conv_epilogue(acc, scale, bias, inv_out_scale, leaky, out_dtype)


def check_epilogue_args(what, x, cout, scale, bias, inv_out_scale, out_dtype):
    """Raise on what the int8 kernels do not take; returns the pointer of the
    requant reciprocal (``scale``'s when the output is f32 and none is read)."""
    if out_dtype not in (torch.int8, torch.float32):
        raise ValueError(f"{what}: out_dtype must be int8 or float32, got {out_dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (cout,) or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous f32 ({cout},) tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if out_dtype == torch.float32:
        return scale.data_ptr()
    if (inv_out_scale is None or inv_out_scale.dtype != torch.float32
            or inv_out_scale.numel() != 1 or inv_out_scale.device != x.device):
        raise ValueError(f"{what}: int8 output needs inv_out_scale as a one-element f32 "
                         f"tensor on {x.device}")
    return inv_out_scale.data_ptr()


def conv1x1_int8_requant(xq, wq, scale, bias, inv_out_scale, *, leaky: bool,
                         out_dtype=torch.int8):
    """xq (M, Cin) int8, wq (Cout, Cin) int8, scale/bias (Cout,) f32,
    inv_out_scale a one-element f32 tensor (unused, may be None, when
    ``out_dtype`` is float32) → (M, Cout) ``out_dtype``, through the
    ``yolov3_torch::conv1x1_int8_requant`` op: CPU tensors take the plain
    version; CUDA tensors launch one kernel (the path of ``plan``; counted in
    ``conv1x1_int8_requant.launches``) or raise."""
    return torch.ops.yolov3_torch.conv1x1_int8_requant.default(
        xq, wq, scale, bias, inv_out_scale, bool(leaky), out_dtype)


conv1x1_int8_requant.launches = 0


@torch.library.custom_op("yolov3_torch::conv1x1_int8_requant", mutates_args=(),
                         device_types="cpu")
def _conv1x1_op(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                inv_out_scale: torch.Tensor | None, leaky: bool,
                out_dtype: torch.dtype) -> torch.Tensor:
    return conv1x1_int8_requant_plain(xq, wq, scale, bias, inv_out_scale, leaky=leaky,
                                      out_dtype=out_dtype)


@_conv1x1_op.register_kernel("cuda")
def _conv1x1_cuda(xq, wq, scale, bias, inv_out_scale, leaky, out_dtype):
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"conv1x1_int8_requant: shapes {tuple(xq.shape)}, {tuple(wq.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or wq.device != xq.device:
        raise ValueError(f"conv1x1_int8_requant: needs int8 on one device, got {xq.dtype}, "
                         f"{wq.dtype}")
    # a loaded program's strides need not be the trace's (``nms_kernel.py``)
    xq, wq = xq.contiguous(), wq.contiguous()
    m, cin = xq.shape
    cout = wq.shape[0]
    if m >= 2 ** 31 or xq.numel() >= 2 ** 31:
        raise ValueError(f"conv1x1_int8_requant: M={m} × Cin={cin} out of range")
    inv_ptr = check_epilogue_args("conv1x1_int8_requant", xq, cout, scale, bias,
                                  inv_out_scale, out_dtype)
    if cin % 16 == 0 and (xq.data_ptr() % 16 or wq.data_ptr() % 16):
        raise ValueError("conv1x1_int8_requant: xq and wq must be 16-byte aligned when "
                         "Cin % 16 == 0")
    out = torch.empty((m, cout), dtype=out_dtype, device=xq.device)
    build.launch(build.function("conv1x1_int8", "conv1x1_int8_launch"), xq.device,
                 "conv1x1_int8", xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), inv_ptr, out.data_ptr(), m, cin, cout, int(bool(leaky)),
                 int(out_dtype == torch.float32))
    conv1x1_int8_requant.launches += 1
    return out


@_conv1x1_op.register_fake
def _conv1x1_fake(xq, wq, scale, bias, inv_out_scale, leaky, out_dtype):
    return xq.new_empty((xq.shape[0], wq.shape[0]), dtype=out_dtype)
