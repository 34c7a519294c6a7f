"""K7 — training BatchNorm's tail: normalize, scale, shift and LeakyReLU in
one CUDA launch forward and one backward, with plain PyTorch versions.

No Pallas kernel: K7 stands for XLA's fusion of the JAX package's
``yolov3_tpu/models/layers.py:342`` ``batch_norm`` and ``:407``
``leaky_relu`` in its train step. Given the batch's (mean, var) from K5
(``bn_stats.py``), or from the bands or sync-BN, and the layer's gamma and
beta:

    forward   y = leaky((x − mean)·scale + beta),  scale = gamma·rsqrt(var + eps)
    backward  g = dy·(v ≥ 0 ? 1 : slope), v the pre-activation
              dx = g·scale  (the direct part; K5's backward adds the part
              through the statistics), dbeta = Σg, dgamma = rsqrt(var + eps)·Σg(x − mean),
              dmean = −scale·Σg, dvar = −½·gamma·rsqrt(var + eps)³·Σg(x − mean)

``x`` is the port's fp activation: logically (B, C, H, W), f32 or bf16,
dense channels-last or NCHW in memory, read where it lies; the (C,) mean and
var are f32, gamma and beta f32 or bf16 (the step's compute dtype). The
forward rounds where the plain expression's element-wise ops round (``x −
mean``, ``·scale``, ``+ beta`` and ``·slope`` each to x's dtype, the
vectors cast to it first) and is bit-equal to it on the card. The backward
recomputes v from x (the same bits), so nothing is saved but x and the
vectors: the tail's mask and ``x − mean`` are not kept for it. Its sums
are f32 in an order fixed by the shape; dx is bit-equal to
``bn_leaky_dx_plain`` on the card, the sums within ``bn_stats.SUM_RTOL``.

On a CUDA tensor each way is one launch (``bn_leaky_fwd_*_kernel``,
``bn_leaky_bwd_*_kernel``; counted in ``bn_leaky.launches`` and
``bn_leaky_dx.launches``); ``_plan`` sizes grid and block from the shape.
The backward's partial sums and ticket counters live in K5's workspace of
the (device, stream): the two kernels never run at once on one stream, and
each leaves the counters at 0. A gradient that reaches the backward in
another memory format than x is copied to x's first (counted in
``bn_leaky_dx.dy_copies``).

``route`` is the routing predicate of ``models/layers.py::batch_norm``:
training-mode BatchNorm followed by LeakyReLU runs through K7 on the card
when ``fallback_reason`` finds nothing K7 lacks; a tensor off the card, and a
float64 one on it (``chip_smoke.py``'s referee), evaluate the plain
expression; any other tail on the card raises. ``bn_leaky.tails`` counts
the training tails by route: ``"fused"`` or the reason.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from . import build
from .bn_stats import _WORKSPACE_HEAD, _workspace

_MAX_CHANNELS = 4096  # channels-last tiles stay within the workspace's 256 ticket counters
_BLOCKS = 528         # 4 blocks of 256 threads on each of 132 SMs: one wave
_PER_THREAD = 16      # vectors a thread should walk before blocks are added


def fallback_reason(x, mean, var, gamma, beta):
    """None when K7's kernels take this training tail, else what they lack:
    a dense channels-last or NCHW f32/bf16 activation of fewer than 2^31
    elements and at most ``_MAX_CHANNELS`` channels, f32 (C,) statistics and
    f32 or bf16 (C,) parameters of one dtype, all on x's device. Whether
    that device is the card is ``route``'s to judge."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        return f"activation {x.dtype} {x.dim()}-d"
    if not (x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)):
        return "layout"
    if x.numel() == 0 or x.numel() >= 2 ** 31 or x.shape[1] > _MAX_CHANNELS:
        return "size"
    c = x.shape[1]
    if any(t.dtype != torch.float32 or tuple(t.shape) != (c,) for t in (mean, var)):
        return "statistics"
    if (gamma.dtype not in (torch.float32, torch.bfloat16) or beta.dtype != gamma.dtype
            or tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,)):
        return "parameters"
    if any(t.device != x.device for t in (mean, var, gamma, beta)):
        return "device"
    return None


def _refusal(what: str, reason: str, x, mean, var, gamma, beta) -> str:
    return (f"{what}: K7 does not take this call ({reason}): x is {x.dtype} "
            f"{tuple(x.shape)} strides {x.stride()} on {x.device}, mean / var "
            f"{mean.dtype} {tuple(mean.shape)} / {var.dtype} {tuple(var.shape)}, gamma / beta "
            f"{gamma.dtype} {tuple(gamma.shape)} / {beta.dtype} {tuple(beta.shape)}")


def route(x, mean, var, gamma, beta) -> str:
    """How ``models/layers.py::batch_norm`` runs a training tail, the key it
    counts in ``bn_leaky.tails``: ``"fused"`` (K7) for a CUDA activation
    ``fallback_reason`` passes; for a tensor off the card, ``"not cuda"`` or
    what K7 would lack there, and for a float64 one on the card (the
    referee's precision) its reason: both evaluate the plain expression.
    Any other tail on the card raises: K7 has no fallback there."""
    reason = fallback_reason(x, mean, var, gamma, beta)
    if x.device.type != "cuda":
        return reason or "not cuda"
    if reason is None:
        return "fused"
    if x.dtype == torch.float64:
        return reason
    raise ValueError(_refusal("bn_leaky", reason, x, mean, var, gamma, beta))


def bn_apply_plain(x, mean, scale, beta):
    """The plain normalization ``(x − mean)·scale + beta`` over channel axis 1,
    in x's dtype with the (C,) vectors cast to it (the JAX package's order)."""
    shape = (1, -1, 1, 1)
    return ((x - mean.to(x.dtype).view(shape))
            * scale.to(x.dtype).view(shape) + beta.to(x.dtype).view(shape))


def bn_leaky_plain(x, mean, var, gamma, beta, eps, slope):
    """Plain PyTorch version of the forward: training BatchNorm's
    normalization, then LeakyReLU, as ``models/layers.py`` writes them."""
    y = bn_apply_plain(x, mean, gamma * torch.rsqrt(var + eps), beta)
    return torch.where(y >= 0, y, y * slope)


def bn_leaky_dx_plain(x, dy, mean, var, gamma, beta, eps, slope):
    """Plain PyTorch version of the backward, the kernel's formulas in f32
    ops: (dx in x's dtype, dmean, dvar f32, dgamma, dbeta in gamma's dtype)."""
    shape = (1, -1, 1, 1)
    r = torch.rsqrt(var + eps)
    g32 = gamma.float()
    scale = (g32 * r).to(x.dtype)
    d = x - mean.to(x.dtype).view(shape)
    v = d * scale.view(shape) + beta.to(x.dtype).view(shape)
    s = scale.float()
    dy32 = dy.float()
    g = torch.where(v >= 0, dy32, dy32 * slope)
    dx = (g * s.view(shape)).to(x.dtype)
    s0 = g.sum(dim=(0, 2, 3))
    s1 = (g * d.float()).sum(dim=(0, 2, 3))
    dmean = -(s * s0)
    dvar = (-0.5 * (s1 * g32)) * (r * r * r)
    return dx, dmean, dvar, (s1 * r).to(gamma.dtype), s0.to(beta.dtype)


def _shape(x):
    """(channels_last, b, c, hw) of an activation K7 takes."""
    b, c, h, w = x.shape
    return x.is_contiguous(memory_format=torch.channels_last), b, c, h * w


def _layout(what: str, x, mean, var, gamma, beta):
    """``_shape`` of a CUDA call K7 takes (``fallback_reason``), or raise."""
    reason = fallback_reason(x, mean, var, gamma, beta)
    if reason is None and x.device.type != "cuda":
        reason = f"unsupported device {x.device}"
    if reason is not None:
        raise ValueError(_refusal(what, reason, x, mean, var, gamma, beta))
    return _shape(x)


@functools.lru_cache(maxsize=None)
def _plan(channels_last: bool, b: int, c: int, hw: int, vec: int, esize: int):
    """(p, per_block, tx, ty), a pure function of the shape and the vector
    width ``vec`` (elements a thread reads at once).

    Channels-last memory, a (B·H·W, C) matrix: blocks of tx × ty threads,
    ``tx`` vectors across (128 bytes of a row, or the whole row when it is
    narrower) and ``ty`` = 256 // tx rows down; a grid of ``p`` blocks along
    the rows, ``per_block`` rows each, times the channel tiles. NCHW planes:
    a block a channel and slice of ``per_block`` elements of its plane in
    every image (``p`` slices a plane, starting on multiples of 8 elements),
    ``tx`` lanes (32 or 256) a group of threads, ``ty`` unused.

    Blocks are added until a thread walks about ``_PER_THREAD`` vectors, up
    to ``_BLOCKS`` in all (one wave), so the backward's last block folds at
    most that many partial rows of a channel."""
    if channels_last:
        cols = c // vec
        tx = min(cols, 128 // (vec * esize))
        ty = 256 // tx
        tiles = -(-cols // tx)
        rows = b * hw
        want = max(1, min(-(-rows // (ty * _PER_THREAD)), _BLOCKS // tiles))
        per_block = -(-rows // want)
        return -(-rows // per_block), per_block, tx, ty
    want = max(1, min(-(-(b * hw) // (256 * vec * _PER_THREAD)), _BLOCKS // c))
    per_block = hw if want == 1 else -(-max(32, -(-hw // want)) // 8) * 8
    return -(-hw // per_block), per_block, 256 if per_block >= 2048 else 32, 1


def _vector(x, tensors, channels_last: bool, c: int, hw: int) -> int:
    """16 bytes a load when every tensor is 16-byte aligned and no vector
    straddles a channel boundary it may not, else one element."""
    per = 16 // x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return per if aligned and (c if channels_last else hw) % per == 0 else 1


@functools.lru_cache(maxsize=None)
def _scalars(eps: float, slope: float):
    """eps and the slope as the f32 values PyTorch's ops use for them."""
    return float(np.float32(eps)), float(np.float32(slope))


def _vectors(mean, var, gamma, beta):
    return [t.contiguous() for t in (mean, var, gamma, beta)]  # (C,); x is never copied


def _forward_cuda(x, mean, var, gamma, beta, eps, slope, layout):
    channels_last, b, c, hw = layout
    vectors = _vectors(mean, var, gamma, beta)
    y = torch.empty_like(x)  # keeps x's memory format
    vec = _vector(x, (x, y), channels_last, c, hw)
    build.launch(build.function("bn_leaky", "bn_leaky_launch"), x.device, "bn_leaky",
                 x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in vectors),
                 x.dtype == torch.bfloat16, gamma.dtype == torch.bfloat16, channels_last,
                 vec > 1, b, c, hw, *_plan(channels_last, b, c, hw, vec, x.element_size()),
                 *_scalars(eps, slope))
    bn_leaky.launches += 1
    return y


def _launch_dx(x, dy, dx, vectors, dstats, dparams, channels_last, vec, b, c, hw, eps, slope,
               stream):
    p, per_block, tx, ty = _plan(channels_last, b, c, hw, vec, x.element_size())
    ws = _workspace(x.device, stream, _WORKSPACE_HEAD + p * 2 * c)
    return build.function("bn_leaky", "bn_leaky_dx_launch")(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in vectors),
        ws.data_ptr(), dstats.data_ptr(), dparams.data_ptr(), x.dtype == torch.bfloat16,
        vectors[2].dtype == torch.bfloat16, channels_last, vec > 1, b, c, hw, p, per_block, tx,
        ty, *_scalars(eps, slope), stream)


def _dx_cuda(x, dy, mean, var, gamma, beta, eps, slope, layout):
    channels_last, b, c, hw = layout
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    if not dy.is_contiguous(memory_format=fmt):
        dy = dy.contiguous(memory_format=fmt)
        bn_leaky_dx.dy_copies += 1
    vectors = _vectors(mean, var, gamma, beta)
    dx = torch.empty_like(x)
    dstats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    dparams = torch.empty((2, c), dtype=gamma.dtype, device=x.device)
    vec = _vector(x, (x, dy, dx), channels_last, c, hw)
    build.launch(_launch_dx, x.device, "bn_leaky_dx", x, dy, dx, vectors, dstats, dparams,
                 channels_last, vec, b, c, hw, eps, slope)
    bn_leaky_dx.launches += 1
    return dx, dstats[0], dstats[1], dparams[0], dparams[1]


def bn_leaky_dx(x, dy, mean, var, gamma, beta, eps, slope):
    """The backward: x, dy (B, C, H, W) → (dx like x, dmean, dvar (C,) f32,
    dgamma, dbeta (C,) in gamma's dtype). CPU tensors take the plain version;
    CUDA tensors launch ``bn_leaky_bwd_*_kernel`` once (counted in
    ``bn_leaky_dx.launches``) or raise."""
    if x.device.type == "cpu":
        return bn_leaky_dx_plain(x, dy, mean, var, gamma, beta, eps, slope)
    layout = _layout("bn_leaky_dx", x, mean, var, gamma, beta)
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"bn_leaky_dx: dy must be like x ({x.dtype} {tuple(x.shape)} on "
                         f"{x.device}), got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    return _dx_cuda(x, dy, mean, var, gamma, beta, eps, slope, layout)


bn_leaky_dx.launches = 0
bn_leaky_dx.dy_copies = 0


class _BnLeaky(torch.autograd.Function):
    """y = leaky(BatchNorm(x)) with the analytic backward above; saves x and
    the (C,) vectors only. ``layout`` is ``_shape(x)`` of a call already
    checked: neither way checks it again."""

    @staticmethod
    def forward(ctx, x, mean, var, gamma, beta, eps: float, slope: float, layout):
        ctx.save_for_backward(x, mean, var, gamma, beta)
        ctx.eps, ctx.slope, ctx.layout = eps, slope, layout
        if x.device.type == "cpu":
            return bn_leaky_plain(x, mean, var, gamma, beta, eps, slope)
        return _forward_cuda(x, mean, var, gamma, beta, eps, slope, layout)

    @staticmethod
    def backward(ctx, dy):
        x, mean, var, gamma, beta = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = bn_leaky_dx_plain(x, dy, mean, var, gamma, beta, ctx.eps, ctx.slope)
        else:
            grads = _dx_cuda(x, dy, mean, var, gamma, beta, ctx.eps, ctx.slope, ctx.layout)
        return grads + (None, None, None)


def bn_leaky(x, mean, var, gamma, beta, eps: float, slope: float):
    """x (B, C, H, W); mean, var (C,) f32; gamma, beta (C,) → y like x,
    differentiable in all five. On a CUDA tensor one launch forward (counted
    in ``bn_leaky.launches``) and one backward, or raise; CPU tensors take
    the plain versions."""
    layout = None if x.device.type == "cpu" else _layout("bn_leaky", x, mean, var, gamma, beta)
    return _BnLeaky.apply(x, mean, var, gamma, beta, eps, slope, layout)


def bn_leaky_routed(x, mean, var, gamma, beta, eps: float, slope: float):
    """``bn_leaky`` for a tail ``route`` took: no check is made again."""
    return _BnLeaky.apply(x, mean, var, gamma, beta, eps, slope, _shape(x))


bn_leaky.launches = 0
bn_leaky.tails = collections.Counter()  # training BN tails: "fused" or the reason (``route``)
