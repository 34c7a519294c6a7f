"""K5 — training-mode BatchNorm statistics: CUDA kernels + plain PyTorch version.

Replaces the Pallas TPU kernel ``yolov3_tpu/ops/pallas/bn_stats.py``
(``bn_sums``, and ``bn_moments`` with its custom VJP):

    sum[c], sumsq[c] = Σ f32(x), Σ f32(x)²     over every non-channel position
    mean = sum / n;   var = max(sumsq / n − mean², 0)         (biased variance)
    backward:  dx = dmean/n + dvar·(2/n)·(x − mean), in x's dtype

``x`` is the port's fp activation: logically (B, C, H, W), f32 or bf16, and
in memory either channels-last or contiguous NCHW (a cuDNN convolution may
hand back either). The kernels read it where it lies, with one code path for
each layout; any other stride pattern raises, and nothing copies or converts
the activation before a launch.

The backward follows the TPU kernel's custom VJP: it does not look at the
``max(·, 0)``, so a channel whose variance clamps still passes ``dvar``
through (differentiating the clamp would pass zero there). The kernel
evaluates it as ``a·x + b`` with per-channel ``a = dvar·(2/n)`` and
``b = dmean·(1/n) − a·mean``, every product and sum rounded once, which is
exactly what the plain version's element-wise ops do: in f32 and in bf16 the
two are bit-equal on one device.

The forward's sums are taken in another order than the plain version's, so
those are held to a tolerance: ``SUM_RTOL`` of Σ|x| and of Σx² against a
float64 reference. Two launches on one input give the same bits (no atomics).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

# |kernel − float64| ≤ SUM_RTOL · Σ|x| for the sum (a sum near zero has no
# relative error of its own), ≤ SUM_RTOL · Σx² for the sum of squares
SUM_RTOL = 1e-5
_TARGET_BLOCKS = 2048  # about two waves of 8 blocks on each of 132 SMs


def _check_activation(what: str, x):
    """(channels_last, b, c, hw) of a dense 4-D f32/bf16 CUDA activation, or raise."""
    if x.dim() != 4:
        raise ValueError(f"{what}: needs a (B, C, H, W) activation, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: needs float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0 or x.numel() >= 2 ** 31:
        raise ValueError(f"{what}: needs 1 ≤ elements < 2^31, got {x.numel()}")
    b, c, h, w = x.shape
    if x.is_contiguous(memory_format=torch.channels_last):
        return True, b, c, h * w
    if x.is_contiguous():
        return False, b, c, h * w
    raise ValueError(f"{what}: the activation must be dense channels-last or NCHW in "
                     f"memory, got shape {tuple(x.shape)} strides {x.stride()}")


def _plan(channels_last: bool, b: int, c: int, hw: int):
    """(p, per_block): blocks along the reduced axis and what each takes —
    rows for channels-last memory, elements of a plane for NCHW planes.
    Fixed by the shape, so the order of every sum is."""
    if channels_last:
        rows = b * hw
        want = max(1, _TARGET_BLOCKS // ((c + 31) // 32))
        per_block = max(32, -(-rows // want))
        per_block = -(-per_block // 8) * 8
        return -(-rows // per_block), per_block
    want = max(1, _TARGET_BLOCKS // c)
    per_block = max(1024, -(-hw // want))
    return -(-hw // per_block), per_block


def bn_sums_plain(x):
    """Plain PyTorch version: per-channel (Σx, Σx²) over axes (0, 2, 3) of a
    (B, C, H, W) activation, in f32."""
    x32 = x.float()
    return x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3))


def bn_sums(x):
    """x (B, C, H, W) f32 or bf16 → (sum, sumsq), two (C,) f32 tensors. CPU
    tensors take the plain version; CUDA tensors launch ``bn_sums_*_kernel``
    and the fold (counted in ``bn_sums.launches``) or raise."""
    if x.device.type == "cpu":
        return bn_sums_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"bn_sums: unsupported device {x.device}")
    channels_last, b, c, hw = _check_activation("bn_sums", x)
    p, per_block = _plan(channels_last, b, c, hw)
    partial = torch.empty((p, 2, c), dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    fn = build.library("bn_stats").bn_sums_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(fn(x.data_ptr(), partial.data_ptr(), out.data_ptr(),
                       int(x.dtype == torch.bfloat16), int(channels_last), b, c, hw, p,
                       per_block, stream), "bn_sums")
    bn_sums.launches += 1
    return out[0], out[1]


bn_sums.launches = 0


def _scalars(n: int):
    """(1/n, 2/n) as the f32 values both versions multiply by."""
    return float(np.float32(1.0 / n)), float(np.float32(2.0 / n))


def bn_moments_dx_plain(x, mean, dmean, dvar):
    """Plain PyTorch version of the backward: ``a·x + b`` per channel, each
    op rounded once in f32, then cast to x's dtype."""
    inv_n, two_inv_n = _scalars(x.numel() // x.shape[1])
    a = dvar * two_inv_n
    b = dmean * inv_n - a * mean
    shape = (1, -1, 1, 1)
    return (a.view(shape) * x.float() + b.view(shape)).to(x.dtype)


def bn_moments_dx(x, mean, dmean, dvar):
    """Gradient of (mean, var) w.r.t. x: x (B, C, H, W); mean, dmean, dvar
    (C,) f32 → dx like x (same dtype and memory format). CPU tensors take the
    plain version; CUDA tensors launch ``bn_dx_kernel`` (counted in
    ``bn_moments_dx.launches``) or raise."""
    if x.device.type == "cpu":
        return bn_moments_dx_plain(x, mean, dmean, dvar)
    if x.device.type != "cuda":
        raise ValueError(f"bn_moments_dx: unsupported device {x.device}")
    channels_last, b, c, hw = _check_activation("bn_moments_dx", x)
    vectors = []
    for name, t in (("mean", mean), ("dmean", dmean), ("dvar", dvar)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or t.device != x.device:
            raise ValueError(f"bn_moments_dx: {name} must be an f32 ({c},) tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        vectors.append(t.contiguous())  # (C,) vectors; the activation is never copied
    dx = torch.empty_like(x)  # keeps x's memory format
    if dx.stride() != x.stride():
        raise ValueError("bn_moments_dx: could not allocate dx in x's memory format")
    ab = torch.empty((2, c), dtype=torch.float32, device=x.device)
    per_vector = 16 // x.element_size()
    vec = (x.data_ptr() % 16 == 0 and dx.data_ptr() % 16 == 0
           and (c if channels_last else hw) % per_vector == 0)
    inv_n, two_inv_n = _scalars(b * hw)
    fn = build.library("bn_stats").bn_moments_dx_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(fn(x.data_ptr(), vectors[1].data_ptr(), vectors[2].data_ptr(),
                       vectors[0].data_ptr(), ab.data_ptr(), dx.data_ptr(),
                       int(x.dtype == torch.bfloat16), int(channels_last), int(vec), b, c, hw,
                       inv_n, two_inv_n, stream), "bn_moments_dx")
    bn_moments_dx.launches += 1
    return dx


bn_moments_dx.launches = 0


class _BnMoments(torch.autograd.Function):
    """(mean, biased var) over axes (0, 2, 3) with the analytic backward of
    the TPU kernel's custom VJP. ``plain`` forces the plain versions."""

    @staticmethod
    def forward(ctx, x, plain: bool):
        n = x.numel() // x.shape[1]
        s, s2 = bn_sums_plain(x) if plain else bn_sums(x)
        mean = s / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        ctx.save_for_backward(x, mean)
        ctx.plain = plain
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, mean = ctx.saved_tensors
        dx = (bn_moments_dx_plain if ctx.plain else bn_moments_dx)(x, mean, dmean, dvar)
        return dx, None


def bn_moments(x):
    """x (B, C, H, W) → (mean, var), two (C,) f32 tensors, differentiable in
    x. On a CUDA tensor forward and backward each launch their kernel."""
    return _BnMoments.apply(x, False)


def bn_moments_plain(x):
    """The same function through the plain versions on any device."""
    return _BnMoments.apply(x, True)
