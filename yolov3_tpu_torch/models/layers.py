"""Primitive layer ops — plain PyTorch functions.

The fp ops take NCHW tensors; the int8 ops (``QAct``, ``dequantize``,
``requantize``, ``add_requant``, ``conv2d_int8``) take and return NHWC, the
JAX package's layout, because an int8 conv is a matrix product only with
channels innermost.

Counterpart of ``yolov3_tpu/models/layers.py``; the semantics are the
reference's Keras layer stack (core/parse_model.py:13-213):

  * convolutional: Darknet padding — 'SAME' for stride 1 (``p=(k-1)//2``
    before, ``k-1-p`` after), explicit ((1,0),(1,0)) zero-pad + VALID for
    stride 2; bias only when no BN; LeakyReLU(0.1).
  * batch norm: Keras eps 1e-3, ``(x-mean)·gamma·rsqrt(var+eps)+beta``; in
    training the batch statistics come from the K5 kernels, momentum 0.99.
  * upsample: nearest-neighbour ×stride.
  * maxpool: Keras MaxPooling2D; 'same' pads are the asymmetric TF ones
    (``_pool_same_pads``: tiny's 2×2 stride-1 pool pads (0, 1)).

Kernels are OIHW (PyTorch's layout); ``models/convert.py`` moves the JAX
package's HWIO kernels across. Quantized kernels (``kernel_q``) are int8
(cout, kh, kw, cin): one row per output channel with the contraction
(tap-major, channel-minor) contiguous, which is what the int8 kernels read.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.cuda import bias_act as _bias_act
from ..ops.cuda import bn_leaky
from ..ops.cuda.bn_stats import bn_moments
from ..ops.cuda.conv1x1 import conv1x1_int8_requant
from ..ops.cuda.conv_int8 import conv_int8
from ..ops.cuda.requant import requant_clip

BN_EPS = 1e-3
BN_MOMENTUM = 0.99
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


def conv2d(x, kernel, stride: int, pad: int, explicit_pad=None, rows=None):
    """Darknet-style conv. x: (B, C, H, W); kernel: (cout, cin, kh, kw).
    ``rows`` (top, bottom) replaces the row padding: a band of the spatial
    split (``parallel/spatial.py``) comes with its halo rows, and pads only
    at the image's own edge."""
    (top, bottom), (left, right) = conv_padding(kernel.shape[2], stride, pad,
                                                explicit_pad)
    if rows is not None:
        top, bottom = rows
    if top == bottom and left == right:
        return F.conv2d(x, kernel.to(x.dtype), stride=stride, padding=(top, left))
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, kernel.to(x.dtype), stride=stride)


def _phase_view(x, phases: int):
    """(B, P·C, H, W) with the channels phase-major → a view whose axis 1 is
    the C channels and whose other axes hold every (image, phase, pixel):
    (B·P, C, H, W) of contiguous NCHW memory, (B·H·W·P, C, 1, 1) of
    channels-last memory (``[B][H][W][P][C]`` is that contiguous tensor).
    Either is a view, never a copy; any other memory raises."""
    b, pc, h, w = x.shape
    c = pc // phases
    if x.is_contiguous():
        return x.view(b * phases, c, h, w)
    if x.is_contiguous(memory_format=torch.channels_last):
        return x.permute(0, 2, 3, 1).view(b * h * w * phases, c, 1, 1)
    raise ValueError(f"batch_norm: the phase view needs NCHW or channels-last memory, got "
                     f"shape {tuple(x.shape)} strides {x.stride()}")


def _subsampled(x, stride: int, row0: int = 0):
    """The stride-``stride`` spatial subsample of ``x`` as a dense copy in
    ``x``'s memory format (1/stride² of its bytes): the statistics kernel
    reads dense activations only. ``row0``: the image row ``x``'s first row
    is (a band of the spatial split); the subsample keeps the image's rows
    0, stride, 2·stride, … whichever band holds them."""
    fmt = (torch.channels_last
           if x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
           else torch.contiguous_format)
    return x[:, :, (-row0) % stride::stride, ::stride].contiguous(memory_format=fmt)


def stats_view(x, phases: int = 1, stats_subsample: int = 1, row0: int = 0):
    """What training-mode BatchNorm takes its statistics over: the
    subsample (``_subsampled``), then the phase view (``_phase_view``)."""
    xs = _subsampled(x, stats_subsample, row0) if stats_subsample > 1 else x
    return _phase_view(xs, phases) if phases > 1 else xs


def batch_norm(x, bn_params, bn_state, train: bool = False, momentum=BN_MOMENTUM, eps=BN_EPS,
               phases: int = 1, stats_subsample: int = 1, group=None, moments=None,
               leaky: bool = False):
    """Functional BatchNorm over channel axis 1, then LeakyReLU when
    ``leaky`` (a conv's tail). Returns ``(y, new_state)``.

    In training mode the statistics are the batch's mean and biased variance
    over (N, H, W), computed in f32 whatever ``x``'s dtype by
    ``ops/cuda/bn_stats.py::bn_moments`` (on a CUDA tensor one kernel launch
    forward and one backward), and the running statistics move by ``momentum``.
    Normalization runs in ``x``'s dtype with ``mean.to(x.dtype)``, as the JAX
    package's does. The new state is detached: no gradient flows into it.

    ``phases > 1``: the channel axis holds ``phases`` spatial-phase groups of
    C = channels / phases channels, phase-major (the space-to-depth training
    stem, ``ops/s2d.py::s2d_stem_train``). The statistics reduce over the
    groups too, through a view of ``x`` (``_phase_view``), which gives the
    un-rewritten layer's per-channel statistics; parameters and state stay
    (C,) and are tiled over the groups to normalize.

    ``stats_subsample`` = s > 1 (training only, an opt-in approximation):
    the statistics come from every s-th row and column, a dense copy of 1/s²
    of the activation (``_subsampled``); the normalization, the gradient
    through the statistics and the running-average update all use that
    estimate.

    ``group`` (training only): a ``torch.distributed`` process group whose
    ranks each hold a shard of the batch; the statistics are the global
    batch's (sync-BN, ``bn_moments``). The phase view and the subsample are
    per image, so they compose with it: the global count is the sum of the
    ranks' counts.

    ``moments`` (training only): the batch's (mean, var), taken elsewhere
    over the bands of a spatial split (``parallel/spatial.py``), on ``x``'s
    device; this call then normalizes ``x``, one band, with them.

    ``leaky`` in training: on the card the normalization and LeakyReLU run
    as K7 (``ops/cuda/bn_leaky.py``, one launch each way, with the
    statistics from wherever they came; the phase groups get the vectors
    tiled to x's channels) or raise (``bn_leaky.route``); a float64 tail
    there, every tail off the card, and inference evaluate the plain
    expression. ``bn_leaky.tails`` counts the training tails by route.
    """
    if train:
        if moments is not None:
            mean, var = moments
        elif group is None:
            # unsynced, the call stays bn_moments(x): the seam a float64 referee replaces
            mean, var = bn_moments(stats_view(x, phases, stats_subsample))
        else:
            mean, var = bn_moments(stats_view(x, phases, stats_subsample), group=group)
        new_state = {
            "mean": (momentum * bn_state["mean"] + (1.0 - momentum) * mean).detach(),
            "var": (momentum * bn_state["var"] + (1.0 - momentum) * var).detach(),
        }
    else:
        mean, var = bn_state["mean"], bn_state["var"]
        new_state = bn_state
    gamma, beta = bn_params["gamma"], bn_params["beta"]
    if train and leaky:
        tiled = [v.repeat(phases) if phases > 1 else v for v in (mean, var, gamma, beta)]
        route = bn_leaky.route(x, *tiled)
        bn_leaky.bn_leaky.tails[route] += 1
        if route == "fused":
            return bn_leaky.bn_leaky_routed(x, *tiled, eps, LEAKY_SLOPE), new_state
    elif train:
        bn_leaky.bn_leaky.tails["no leaky"] += 1
    scale = gamma * torch.rsqrt(var + eps)
    if phases > 1:
        mean, scale, beta = (v.repeat(phases) for v in (mean, scale, beta))
    y = bn_leaky.bn_apply_plain(x, mean, scale, beta)
    return (leaky_relu(y) if leaky else y), new_state


def s2d_phase_kernel_conv0(k):
    """(cout, cin, 3, 3) → (4·cout, cin, 4, 4): the space-to-depth stem's
    phase-stacked strided conv0, built from the original kernel inside the
    differentiated graph (pad + concatenate: linear), so the four phase
    groups' gradients sum back onto the one 3×3 kernel. Group g = 2·pi + pj
    is the kernel placed at offset (pi, pj); ``ops/s2d.py`` has the geometry."""
    return torch.cat([F.pad(k, (pj, 1 - pj, pi, 1 - pi))
                      for pi in range(2) for pj in range(2)], dim=0)


def s2d_phase_kernel_conv1(k):
    """(cout, cin, 3, 3) → (cout, 4·cin, 2, 2): the phase-consuming conv1.
    Tap (a, b) of input phase group (qi, qj) reads original tap
    (2a + qi − 1, 2b + qj − 1); taps outside the 3×3 window are the zeros of
    a padded kernel sliced with stride 2."""
    kp = F.pad(k, (1, 1, 1, 1))
    return torch.cat([kp[:, :, qi:qi + 3:2, qj:qj + 3:2]
                      for qi in range(2) for qj in range(2)], dim=1)


def leaky_relu(x, slope=LEAKY_SLOPE):
    return torch.where(x >= 0, x, x * slope)


def mish(x):
    """Mish (Misra, arXiv:1908.08681), YOLOv4's backbone activation:
    ``x·tanh(softplus(x))``, ATen's kernel in ``x``'s dtype."""
    return F.mish(x)


def bias_act(x, bias, activation: str):
    """A conv's tail after its bias: ``x + bias`` over channel axis 1 (the
    bias cast to x's dtype), then ``activation`` (``spec.ACTIVATIONS``:
    ``leaky_relu``, ``mish`` or none). A tail that autograd records (the
    train step's linear heads, QAT) evaluates that plain expression; every
    other tail is the ``yolov3_torch::bias_act`` op, one K8 launch on the
    card (``ops/cuda/bias_act.py``; a tail K8 cannot take raises) and the
    same expression on the CPU. ``bias_act.tails`` counts the tails by
    route (``bias_act.route``)."""
    route = _bias_act.route(x, bias)
    _bias_act.bias_act.tails[route] += 1
    if route == "fused":
        return _bias_act.bias_act(x, bias, activation)
    return _bias_act.bias_act_plain(x, bias, activation)


def upsample_nearest(x, stride: int):
    return x.repeat_interleave(stride, dim=2).repeat_interleave(stride, dim=3)


# ---------------------------------------------------------------------------
# int8 tier (NHWC)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QAct:
    """Quantized activation flowing between layers: symmetric int8 + scale.

    fp value = q * scale. ``q`` is a contiguous NHWC int8 tensor, ``scale`` a
    0-d float32 tensor on the same device (a Python float is f64 and would
    round the products elsewhere than the JAX package's f32 scalars do).
    Deliberately not a tuple: the interpreter tells single activations from
    multi-input lists with isinstance checks.
    """

    q: torch.Tensor
    scale: torch.Tensor


def dequantize(x: QAct, dtype=torch.float32):
    return (x.q.to(torch.float32) * x.scale).to(dtype)


def requantize(y32, out_scale) -> QAct:
    """fp32 → symmetric int8 at ``out_scale``: multiply by the f32 reciprocal
    (computed once), round half to even, clip to ±127."""
    inv = torch.reciprocal(out_scale)
    return QAct(requant_clip(y32, inv).to(torch.int8), out_scale)


def add_requant(a: QAct, b: QAct, out_scale) -> QAct:
    """Shortcut of two int8 activations: dequantize both, add in fp32,
    requantize."""
    y32 = a.q.to(torch.float32) * a.scale + b.q.to(torch.float32) * b.scale
    return requantize(y32, out_scale)


def quantize_input(x, in_scale):
    """fp activation → int8 at ``in_scale`` (a true f32 division, as the JAX
    package's)."""
    return torch.clamp(torch.round(x.to(torch.float32) / in_scale), -127, 127).to(torch.int8)


def conv2d_int8(x, qparams, stride: int, pad: int, leaky: bool = False,
                fp_dtype=torch.float32, explicit_pad=None, rows=None):
    """Quantized conv: int8 weights × int8 activations, int32 sums, rescale.

    qparams: ``kernel_q`` int8 (cout, kh, kw, cin); ``w_scale`` (cout,) f32;
    ``in_scale`` () f32 (used only when ``x`` is an fp tensor); ``bias``
    (cout,) f32 (BN folded); optional ``out_scale`` () f32 — when present
    the epilogue requantizes and a ``QAct`` comes back, so conv chains stay
    int8 end to end.

    ``x``: an fp NHWC tensor (quantized here with ``in_scale``; the result is
    fp NHWC in ``x.dtype``) or a ``QAct`` (consumed as it is). A 1×1 stride-1
    conv goes to the fused matmul kernel (``ops/cuda/conv1x1.py``), every
    other shape to the implicit-GEMM kernel (``ops/cuda/conv_int8.py``); on
    CPU tensors both wrappers run their plain versions. ``rows``: see
    ``conv2d`` (K6 takes the per-side padding as it is).
    """
    if isinstance(x, QAct):
        xq, in_scale = x.q, x.scale
    else:
        in_scale = qparams["in_scale"]
        fp_dtype = x.dtype
        xq = quantize_input(x, in_scale).contiguous()
    kq = qparams["kernel_q"]
    cout, kh, kw, cin = kq.shape
    scale = (qparams["w_scale"] * in_scale).to(torch.float32)
    out_scale = qparams.get("out_scale")
    inv = None if out_scale is None else torch.reciprocal(out_scale)
    out_dtype = torch.int8 if out_scale is not None else torch.float32
    if kh == 1 and kw == 1 and stride == 1 and explicit_pad is None:
        b, h, w, _ = xq.shape
        y = conv1x1_int8_requant(xq.reshape(-1, cin), kq.reshape(cout, cin), scale,
                                 qparams["bias"], inv, leaky=leaky,
                                 out_dtype=out_dtype).reshape(b, h, w, cout)
    else:
        padding = conv_padding(kh, stride, pad, explicit_pad)
        if rows is not None:
            padding = (tuple(rows), padding[1])
        y = conv_int8(xq, kq, scale, qparams["bias"], inv, stride=stride, padding=padding,
                      leaky=leaky, out_dtype=out_dtype)
    if out_scale is not None:
        return QAct(y, out_scale)
    return y.to(fp_dtype)


def _pool_same_pads(hw, size_xy, stride_xy):
    pads = []
    for dim, k, s in zip(hw, size_xy, stride_xy):
        out = -(-dim // s)  # ceil
        total = max((out - 1) * s + k - dim, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def max_pool(x, size_xy, stride_xy, padding: str, pads=None):
    """Keras MaxPooling2D over (B, C, H, W). ``pads`` ((top, bottom),
    (left, right)) replaces the 'same' padding: a band of the spatial split
    pads −inf only at the image's own edge."""
    if pads is None and padding.lower() == "same":
        pads = _pool_same_pads(x.shape[2:4], size_xy, stride_xy)
    if pads is not None and any(pads[0] + pads[1]):
        (top, bottom), (left, right) = pads
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
