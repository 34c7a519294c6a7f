"""Plain PyTorch YOLOv3 / YOLOv3-tiny in float32: the forward the benchmark
judges the port by.

It follows the published Darknet layer semantics as the repository's model
files spell them (Redmon & Farhadi, arXiv:1804.02767; Darknet's
``yolov3.cfg`` and ``yolov3-tiny.cfg``):

  * convolutional: stride 1 pads ``(k-1)//2`` before and the rest after,
    stride 2 pads one row and column before and none after (Darknet's
    top-left pad), then a plain convolution; BatchNorm (epsilon 1e-3) or a
    bias; LeakyReLU with slope 0.1;
  * shortcut: the sum of the layer ``from`` back and the previous one;
  * route: one source as it is, two concatenated on the channels (the
    listed layers first, then the sub-model's inputs);
  * upsample: nearest neighbour; maxpool: TensorFlow's ``same`` padding with
    minus infinity;
  * yolo: the raw head, viewed as (B, g, g, 3, 5 + classes).

Activations are NCHW float32. Nothing here imports the port: the graph comes
from the model YAML (``graph.py``) and the weights from the benchmark.
``FloatOps`` runs inference over BatchNorm folded into the convolutions,
``TrainOps`` training-mode BatchNorm over the batch's statistics
(``momentum`` 0 makes the running statistics the batch's own). Both take
an optional ``rounding`` that rounds every convolution's input and weight
and the gradient of its output: the low-precision control (``lowp.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.99
LEAKY = 0.1


def ieee_fp32():
    """Float32 convolutions and matmuls on the card in IEEE float32, never
    TF32 (the legacy flags first: newer torch checks them against the new
    per-backend settings)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if hasattr(torch.backends.cudnn, "conv"):
        torch.backends.cudnn.conv.fp32_precision = "ieee"
        torch.backends.cuda.matmul.fp32_precision = "ieee"


def conv_pads(k: int, stride: int, pad: int = 1):
    """(top, bottom, left, right) zero padding of a Darknet convolution."""
    if stride > 1:
        return 1, 0, 1, 0
    if pad:
        p = (k - 1) // 2
        return p, k - 1 - p, p, k - 1 - p
    return 0, 0, 0, 0


def pool_pads(h: int, w: int, k: int, s: int):
    """(top, bottom, left, right) of TensorFlow's ``same`` pooling."""
    out = []
    for dim in (h, w):
        total = max((-(-dim // s) - 1) * s + k - dim, 0)
        out.append((total // 2, total - total // 2))
    return out[0][0], out[0][1], out[1][0], out[1][1]


def darknet_conv(x, kernel, stride: int, pad: int = 1):
    top, bottom, left, right = conv_pads(kernel.shape[2], stride, pad)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), kernel, stride=stride)


def leaky(x):
    return torch.where(x >= 0, x, x * LEAKY)


def maxpool(x, layer):
    (k, _), (s, _) = layer["size_xy"], layer["stride_xy"]
    if str(layer.get("padding", "valid")).lower() == "same":
        top, bottom, left, right = pool_pads(x.shape[2], x.shape[3], k, s)
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def head(x, nclasses: int):
    b, _, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h, w, 3, 5 + nclasses)


def fold_bn(params, state, eps: float = BN_EPS):
    """{(sm, i): (kernel, bias)}: BatchNorm folded into each convolution,
    ``kernel · s`` and ``beta − mean · s`` with ``s = gamma / sqrt(var + eps)``."""
    folded = {}
    for sm_name, sm_params in params.items():
        for key, entry in sm_params.items():
            i = int(key[len("layer"):])
            if "bn" in entry:
                st = state[sm_name][key]
                s = entry["bn"]["gamma"] / torch.sqrt(st["var"] + eps)
                folded[(sm_name, i)] = (entry["kernel"] * s.view(-1, 1, 1, 1),
                                        entry["bn"]["beta"] - st["mean"] * s)
            else:
                folded[(sm_name, i)] = (entry["kernel"], entry["bias"])
    return folded


class FloatOps:
    """Inference in float32 over folded convolutions ({(sm, i): (kernel, bias)})."""

    def __init__(self, folded, nclasses: int, rounding=None):
        self.folded, self.nclasses, self.rounding = folded, nclasses, rounding

    def image(self, images):
        return images.float().permute(0, 3, 1, 2)

    def conv(self, key, layer, x):
        kernel, bias = self.folded[key]
        if self.rounding is not None:
            x, kernel = self.rounding.activation(x), self.rounding.weight(kernel)
        y = darknet_conv(x, kernel, int(layer["stride"]), int(layer.get("pad", 1)))
        if self.rounding is not None:
            y = self.rounding.output(y)
        y = y + bias.view(1, -1, 1, 1)
        return leaky(y) if layer.get("activation") == "leaky" else y

    def shortcut(self, key, other, x):
        return other + x

    def route(self, key, parts):
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def upsample(self, key, x, s):
        return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)

    def maxpool(self, key, x, layer):
        return maxpool(x, layer)

    def head(self, key, x):
        return head(x, self.nclasses)


class TrainOps(FloatOps):
    """Training-mode forward over unfolded ``params`` / ``state`` (the
    port's nested dicts): each BatchNorm normalizes with the batch's mean
    and biased variance and records its moved running statistics in
    ``new_state`` (momentum 0.99)."""

    def __init__(self, params, state, nclasses: int, rounding=None, momentum=BN_MOMENTUM):
        super().__init__(None, nclasses, rounding)
        self.params, self.state, self.new_state = params, state, {}
        self.momentum = momentum

    def conv(self, key, layer, x):
        sm, i = key
        entry = self.params[sm][f"layer{i}"]
        kernel = entry["kernel"]
        if self.rounding is not None:
            x, kernel = self.rounding.activation(x), self.rounding.weight(kernel)
        y = darknet_conv(x, kernel, int(layer["stride"]), int(layer.get("pad", 1)))
        if self.rounding is not None:
            y = self.rounding.output(y)
        if "bn" in entry:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
            st = self.state[sm][f"layer{i}"]
            self.new_state.setdefault(sm, {})[f"layer{i}"] = {
                "mean": (self.momentum * st["mean"] + (1 - self.momentum) * mean).detach(),
                "var": (self.momentum * st["var"] + (1 - self.momentum) * var).detach()}
            scale = entry["bn"]["gamma"] * torch.rsqrt(var + BN_EPS)
            y = (y - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1) + entry["bn"]["beta"].view(
                1, -1, 1, 1)
        else:
            y = y + entry["bias"].view(1, -1, 1, 1)
        return leaky(y) if layer.get("activation") == "leaky" else y


def run_graph(graph, images, ops, observer=None):
    """The forward: ``images`` (B, H, W, 3) → the heads' outputs in graph
    order, each (B, g, g, 3, 5 + classes). ``observer(key, kind, x_in,
    x_out)``, when given, sees every layer's input and output as ``ops``
    holds them."""
    produced = {}
    x0 = ops.image(images)
    heads = []
    for sm in graph:
        inputs = [x0] if sm["inputs"] is None else [produced[n][j] for n, j in sm["inputs"]]
        x, outs = inputs[0], []
        for i, layer in enumerate(sm["layers"]):
            key, kind = (sm["name"], i), layer["type"]
            x_in = x
            if kind == "convolutional":
                x = ops.conv(key, layer, x)
            elif kind == "shortcut":
                x = ops.shortcut(key, outs[int(layer["from"])], x)
            elif kind == "route":
                src = layer["source"]
                x = ops.route(key, [outs[j] for j in src.get("layers", [])]
                              + [inputs[j] for j in src.get("inputs", [])])
            elif kind == "upsample":
                x = ops.upsample(key, x, int(layer["stride"]))
            elif kind == "maxpool":
                x = ops.maxpool(key, x, layer)
            elif kind == "yolo":
                x = ops.head(key, x)
                heads.append(x)
            else:
                raise ValueError(f"unknown layer type {kind}")
            if observer is not None:
                observer(key, kind, x_in, x)
            outs.append(x)
        produced[sm["name"]] = [outs[j] for j in sm["outputs"]]
    return heads
