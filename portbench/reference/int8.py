"""The int8 serving tier worked out again from the float weights: calibration,
per-channel weight quantization and the ``int8_chain`` requantization chain,
in plain PyTorch.

What the tier computes, from the port's stated contract (``apps/
inference_app.py::make_predictor``, ``ops/quantize.py``, ``models/layers.py``),
not from its code:

  * calibration: one float32 forward of the folded model over the
    calibration images; every conv's input abs-max and every layer's output
    abs-max. A scale is ``f32(absmax / L)`` (the quotient in float64);
  * weights: per output channel, ``w_scale = f32(absmax / L)`` (at least
    1e-12), integers ``clip(round(kernel / w_scale), ±L)``, half to even;
  * a quantized conv takes int8 input (an fp input is quantized with its
    input scale by a true division), sums exactly, then
    ``y = f32(sum) · f32(w_scale · s_in) + bias``, LeakyReLU 0.1, and
    requantizes with the f32 reciprocal of its output scale: round half to
    even, clip ±L. The heads' final 1×1 convs stay float32;
  * a shortcut of two int8 activations adds ``q·scale`` of the earlier one
    and of the later one in float32 and requantizes at its own output scale;
    upsample and maxpool keep the integers and the scale; a route of two
    sources concatenates their float values.

``L`` is 127; 7 gives the int4 control (``lowp.py``). The space-to-depth
stem the port builds for its first two convs sums the same integer
products in another order, so the plain convolutions here stand for it.
Integer sums run in float64, where they are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .graph import head_convs
from .model import FloatOps, darknet_conv, fold_bn, leaky, maxpool, run_graph


class Q(NamedTuple):
    """An integer activation: ``q`` (NCHW float32 holding integers) × ``scale``."""

    q: torch.Tensor
    scale: torch.Tensor


def _scale(absmax: float, lattice: int, device):
    return torch.tensor(absmax / float(lattice), dtype=torch.float32, device=device)


def deq(x):
    return x.q * x.scale if isinstance(x, Q) else x


def requant(y, out_scale, lattice: int):
    return Q(torch.clamp(torch.round(y * torch.reciprocal(out_scale)), -lattice, lattice),
             out_scale)


@torch.no_grad()
def calibrate(graph, folded, nclasses: int, images):
    """(conv input abs-max, layer output abs-max) over ``images``, as two
    dicts keyed by (sm, i) of Python floats."""
    in_max, out_max = {}, {}

    def observe(key, kind, x_in, x_out):
        if kind == "convolutional":
            in_max[key] = x_in.abs().max()
        out_max[key] = x_out.abs().max()

    run_graph(graph, images, FloatOps(folded, nclasses), observer=observe)
    keys_in, keys_out = list(in_max), list(out_max)
    values = torch.stack([in_max[k] for k in keys_in] + [out_max[k] for k in keys_out]).tolist()
    return (dict(zip(keys_in, values[:len(keys_in)])),
            dict(zip(keys_out, values[len(keys_in):])))


def quantize(graph, folded, in_max, out_max, lattice: int = 127, chain: bool = True):
    """The quantized model: ``{"conv": {(sm, i): entry}, "shortcut": {(sm, i):
    out_scale}}``; an entry holds ``kernel``/``bias`` (float, the heads) or
    ``kq``, ``w_scale``, ``in_scale``, ``bias`` and, chained, ``out_scale``."""
    skip = head_convs(graph)
    device = next(iter(folded.values()))[0].device
    convs, shortcuts = {}, {}
    for key, (kernel, bias) in folded.items():
        if key in skip or in_max.get(key, 0.0) <= 0:
            convs[key] = {"kernel": kernel, "bias": bias}
            continue
        w_absmax = torch.clamp(kernel.abs().amax(dim=(1, 2, 3)), min=1e-12)
        # a true division: a CUDA tensor divided by a Python number is a
        # product with its f32 reciprocal, one ulp off in many channels
        w_scale = w_absmax / torch.full_like(w_absmax, float(lattice))
        entry = {"kq": torch.clamp(torch.round(kernel / w_scale.view(-1, 1, 1, 1)),
                                   -lattice, lattice),
                 "w_scale": w_scale, "in_scale": _scale(in_max[key], lattice, device),
                 "bias": bias}
        if chain and out_max.get(key, 0.0) > 0:
            entry["out_scale"] = _scale(out_max[key], lattice, device)
        convs[key] = entry
    if chain:
        for sm in graph:
            for i, layer in enumerate(sm["layers"]):
                key = (sm["name"], i)
                if layer["type"] == "shortcut" and out_max.get(key, 0.0) > 0:
                    shortcuts[key] = _scale(out_max[key], lattice, device)
    return {"conv": convs, "shortcut": shortcuts}


class Int8Ops(FloatOps):
    """The quantized forward over ``quantize``'s model."""

    def __init__(self, qmodel, nclasses: int, lattice: int = 127):
        super().__init__(None, nclasses)
        self.qmodel, self.lattice = qmodel, lattice

    def conv(self, key, layer, x):
        entry = self.qmodel["conv"][key]
        stride, pad = int(layer["stride"]), int(layer.get("pad", 1))
        act = layer.get("activation") == "leaky"
        if "kq" not in entry:
            y = darknet_conv(deq(x), entry["kernel"], stride, pad)
            y = y + entry["bias"].view(1, -1, 1, 1)
            return leaky(y) if act else y
        if isinstance(x, Q):
            xq, s_in = x.q, x.scale
        else:
            xq = torch.clamp(torch.round(x / entry["in_scale"]), -self.lattice, self.lattice)
            s_in = entry["in_scale"]
        acc = darknet_conv(xq.double(), entry["kq"].double(), stride, pad).float()
        scale = entry["w_scale"] * s_in
        y = acc * scale.view(1, -1, 1, 1) + entry["bias"].view(1, -1, 1, 1)
        if act:
            y = leaky(y)
        if "out_scale" in entry:
            return requant(y, entry["out_scale"], self.lattice)
        return y

    def shortcut(self, key, other, x):
        out_scale = self.qmodel["shortcut"].get(key)
        if out_scale is not None and isinstance(other, Q) and isinstance(x, Q):
            return requant(other.q * other.scale + x.q * x.scale, out_scale, self.lattice)
        return deq(other) + deq(x)

    def route(self, key, parts):
        return parts[0] if len(parts) == 1 else torch.cat([deq(p) for p in parts], dim=1)

    def upsample(self, key, x, s):
        if isinstance(x, Q):
            return Q(super().upsample(key, x.q, s), x.scale)
        return super().upsample(key, x, s)

    def maxpool(self, key, x, layer):
        if isinstance(x, Q):
            return Q(maxpool(x.q, layer), x.scale)
        return maxpool(x, layer)

    def head(self, key, x):
        return super().head(key, deq(x))


def int8_model(graph, params, state, nclasses: int, calibration_images, lattice: int = 127):
    """Fold, calibrate and quantize: the ``int8_chain`` tier (``lattice``
    127) from the float weights and the calibration images alone."""
    folded = fold_bn(params, state)
    in_max, out_max = calibrate(graph, folded, nclasses, calibration_images)
    return quantize(graph, folded, in_max, out_max, lattice)
