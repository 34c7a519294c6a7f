"""K8 — the tail of a folded fp conv: bias add and activation in one CUDA
pass, y = act(x + bias) with act one of linear, leaky (slope 0.1) and Mish;
with its plain PyTorch version.

No Pallas kernel: K8 stands for XLA's fusion of the folded conv's bias add
and ``yolov3_tpu/models/layers.py``'s ``leaky_relu`` on the JAX package's
serving path (Mish is YOLOv4's, which the JAX package does not run). It is
bound by bytes: the plain expression makes two to four passes over the
activation (the add; then ``where``'s compare, multiply and select, or
ATen's Mish), K8 reads x once and writes y once.

``x`` is the port's fp activation: logically (B, C, H, W), f32 or bf16,
dense channels-last or NCHW in memory, read where it lies; ``bias`` is (C,)
f32 or bf16, cast to x's dtype first as the plain expression casts it. The
kernel rounds where the plain expression's element-wise ops round
(``csrc/bias_act.cu``) and is bit-equal to it on the card. y is a new tensor
in x's memory format.

``bias_act`` is the ``yolov3_torch::bias_act`` op (see ``nms_kernel.py``):
its CPU kernel is ``bias_act_plain``, its CUDA kernel one launch of
``bias_act_{linear,leaky,mish}_kernel`` (counted in ``bias_act.launches``)
or a raise for a tensor K8 does not take, its fake kernel keeps x's shape,
dtype and memory format, so ``torch.export`` keeps each tail as one node.
In bf16 the Mish kernel reads most results from a table of 4,096 entries
that ``_mish_table`` computes once a device.

``route`` is the routing predicate of ``models/layers.py::bias_act``: a tail
that autograd records (the train step's linear heads, QAT) keeps the plain
expression, which is differentiable; every other tail calls the op.
``bias_act.tails`` counts the tails by route: ``"fused"`` or the reason.
"""

from __future__ import annotations

import collections
import functools

import torch
import torch.nn.functional as F

from . import build

ACTIVATIONS = ("linear", "leaky", "mish")  # the kernel's codes 0, 1, 2
_CODES = {a: i for i, a in enumerate(ACTIVATIONS)}
_DTYPES = (torch.float32, torch.bfloat16)
SLOPE = 0.1
_THREADS = 256
_MAX_ELEMENTS = 2 ** 31 - 1  # a launch's flat index is 32 bits
_TABLE_SIZE = 4096


def bias_act_plain(x, bias, activation: str):
    """The plain expression: ``x + bias`` over channel axis 1 with the bias
    cast to x's dtype, then LeakyReLU as ``torch.where`` or ATen's Mish."""
    y = x + bias.to(x.dtype).view(1, -1, 1, 1)
    if activation == "leaky":
        return torch.where(y >= 0, y, y * SLOPE)
    if activation == "mish":
        return F.mish(y)
    if activation != "linear":
        raise ValueError(f"bias_act: activation must be one of {ACTIVATIONS}, got {activation!r}")
    return y


def route(x, bias) -> str:
    """How ``models/layers.py::bias_act`` runs a conv's tail, the key it
    counts in ``bias_act.tails``: ``"autograd"`` where autograd records the
    tail (grad mode on and x or the bias requiring grad), which keeps the
    plain expression; else ``"fused"``, the op (K8 on the card, the plain
    version on the CPU)."""
    if torch.is_grad_enabled() and (x.requires_grad or bias.requires_grad):
        return "autograd"
    return "fused"


def bias_act(x, bias, activation: str):
    """x (B, C, H, W) f32 or bf16, bias (C,) → act(x + bias) like x, through
    the ``yolov3_torch::bias_act`` op: CPU tensors take the plain version;
    CUDA tensors launch K8 once (counted in ``bias_act.launches``) or raise."""
    return _op(x, bias, activation)


bias_act.launches = 0
bias_act.tails = collections.Counter()  # conv tails with a bias: "fused" or the reason (``route``)


def _refusal(reason: str, x, bias) -> str:
    return (f"bias_act: K8 does not take this call ({reason}): x is {x.dtype} "
            f"{tuple(x.shape)} strides {x.stride()} on {x.device}, bias {bias.dtype} "
            f"{tuple(bias.shape)} on {bias.device}")


def _check(x, bias, activation):
    """x's layout (True: channels-last) for a call K8 takes, else raise. A
    tensor dense in both layouts (C = 1 or H = W = 1) gives every element the
    same channel either way."""
    if activation not in _CODES:
        raise ValueError(f"bias_act: activation must be one of {ACTIVATIONS}, got {activation!r}")
    shape = x.shape
    if x.dtype not in _DTYPES or len(shape) != 4:
        raise ValueError(_refusal(f"activation {x.dtype} {len(shape)}-d", x, bias))
    if x.is_contiguous(memory_format=torch.channels_last):
        channels_last = True
    elif x.is_contiguous():
        channels_last = False
    else:
        raise ValueError(_refusal("layout", x, bias))
    if (bias.dtype not in _DTYPES or bias.shape != shape[1:2]
            or bias.get_device() != x.get_device()):
        raise ValueError(_refusal("bias", x, bias))
    if shape[0] and shape[1] * shape[2] * shape[3] > _MAX_ELEMENTS:
        raise ValueError(_refusal("an image of 2^31 elements or more", x, bias))
    return channels_last


def plan(n: int, vec: int) -> int:
    """Blocks of ``_THREADS`` threads for n elements in vectors of ``vec``: a
    thread for each whole vector and each of the last ``n % vec`` elements."""
    return -(-(n // vec + n % vec) // _THREADS)


_tables: dict = {}


def _mish_table(device):
    """Mish's bf16 table on ``device`` (``csrc/bias_act.cu``: the 4,096 bf16
    numbers with |v| in [2^-8, 2^8) and their results), computed by one launch
    the first time a device asks and kept for the process."""
    key = device.index
    if key not in _tables:
        table = torch.empty(_TABLE_SIZE, dtype=torch.int16, device=torch.device("cuda", key))
        build.launch(build.function("bias_act", "bias_act_mish_table_launch"), table.device,
                     "bias_act_mish_table", table.data_ptr())
        torch.cuda.synchronize(key)  # ready for every stream that reads it
        _tables[key] = table
    return _tables[key]


@functools.cache
def _launcher():
    """K8's ctypes launch function, looked up once a process."""
    return build.function("bias_act", "bias_act_launch")


def _launch(x, bias, y, code, channels_last):
    """One launch over x (more only for a batch of 2^31 elements or more:
    whole images a launch)."""
    b, c, h, w = x.shape
    is_bf16 = x.dtype == torch.bfloat16
    table = _mish_table(x.device).data_ptr() if code == 2 and is_bf16 else None
    args = (table, is_bf16, bias.dtype == torch.bfloat16, channels_last, code)
    n, image = x.numel(), c * h * w
    step = b if n <= _MAX_ELEMENTS else _MAX_ELEMENTS // image  # images a launch
    esize, xp, yp, bp = x.element_size(), x.data_ptr(), y.data_ptr(), bias.data_ptr()
    for b0 in range(0, b, step):
        n = min(step, b - b0) * image
        xi, yi = xp + b0 * image * esize, yp + b0 * image * esize
        vec = 16 // esize if (xi | yi) % 16 == 0 else 1
        build.launch(_launcher(), x.device, "bias_act", xi, bp, yi, *args, vec > 1, n, c,
                     h * w, plan(n, vec))
        bias_act.launches += 1


@torch.library.custom_op("yolov3_torch::bias_act", mutates_args=(), device_types="cpu")
def _bias_act_op(x: torch.Tensor, bias: torch.Tensor, activation: str) -> torch.Tensor:
    return bias_act_plain(x, bias, activation)


@_bias_act_op.register_kernel("cuda")
def _bias_act_cuda(x, bias, activation):
    channels_last = _check(x, bias, activation)
    y = torch.empty_like(x)  # keeps x's memory format
    if x.numel():
        _launch(x, bias.contiguous(), y, _CODES[activation], channels_last)
    return y


@_bias_act_op.register_fake
def _bias_act_fake(x, bias, activation):
    return torch.empty_like(x)


_op = torch.ops.yolov3_torch.bias_act.default
