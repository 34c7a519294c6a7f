"""Run an exported TFJS graph-model in PyTorch, on the card or the CPU.

``GraphModel`` reads the files ``export/tfjs_graph.write_graph_model`` writes
(the same files a browser fetches with ``tf.loadGraphModel``), dequantizes the
manifest as ``read_graph_model`` does, holds every Const as a buffer on the
chosen device and runs the nodes in their order over the ops of
``TFJS_SUPPORTED_OPS``, as the TFJS runtime executes them. It needs no
TensorFlow: the graph is NHWC, and the executor runs its 4-D activations in
NCHW inside (the convolutions are ``F.conv2d``, cuDNN on the card; fp32 is
pinned to IEEE there, ``device.pin_fp32_ieee``) and returns the heads in
NHWC, sorted 13-grid first as ``js/src/inference.js`` sorts them.

TensorFlow's semantics that the ops keep:
  * ``SAME`` padding puts the odd row and column at the bottom and right
    (``_same_pads``); a ``MaxPool`` pads with −inf, a ``Conv2D`` with 0
    (the tiny's 2×2 stride-1 pool is such a case);
  * ``Pad`` takes its paddings from a Const (the Darknet stride-2 conv is
    ``Pad [[0,0],[1,0],[1,0],[0,0]]`` then a ``VALID`` conv);
  * ``ResizeNearestNeighbor`` with ``align_corners`` and
    ``half_pixel_centers`` false is TF1's nearest, ``F.interpolate``'s
    ``nearest``; other settings raise;
  * ``ConcatV2`` and ``Reshape`` take their axis and shape from Consts, in
    NHWC terms.

    model = GraphModel("tfjs_model", device="cuda")
    heads = model(torch.from_numpy(images).cuda())   # (1, S, S, 3) float32
"""

from __future__ import annotations

import base64

import numpy as np
import torch
import torch.nn.functional as F

from ..device import pin_fp32_ieee, resolve_device
from .tfjs_graph import TFJS_SUPPORTED_OPS, read_graph_model

# an NHWC axis of a 4-D activation → the NCHW axis it is held in
_NHWC_TO_NCHW = (0, 2, 3, 1)


def _attr_str(node, key) -> str:
    return base64.b64decode(node["attr"][key]["s"]).decode()


def _attr_ints(node, key):
    return [int(v) for v in node["attr"][key]["list"].get("i", [])]


def _attr_bool(node, key) -> bool:
    return bool(node["attr"].get(key, {}).get("b", False))


def _same_pads(size: int, kernel: int, stride: int):
    """TensorFlow's SAME padding of one axis → (before, after), the odd one after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class GraphModel(torch.nn.Module):
    """An exported graph-model loaded once onto ``device`` (the card unless
    the caller passes ``device="cpu"``); calling it runs the graph on an NHWC
    float32 batch and returns the heads (NHWC), 13-grid first."""

    def __init__(self, model_dir: str, device=None):
        super().__init__()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            pin_fp32_ieee(self.device)
        model_json, weight_map = read_graph_model(model_dir)
        self.weight_map = weight_map  # the dequantized payloads, as read
        signature = model_json["signature"]
        (self.input_name,) = signature["inputs"].keys()
        self.output_names = [v["name"].split(":")[0] for v in signature["outputs"].values()]
        self.nodes = model_json["modelTopology"]["node"]
        unsupported = sorted({n["op"] for n in self.nodes} - TFJS_SUPPORTED_OPS)
        if unsupported:
            raise ValueError(f"graph contains ops outside the TFJS registry: {unsupported}")
        kernels = {n["input"][1] for n in self.nodes if n["op"] == "Conv2D"}
        # every Const is a buffer; a conv's kernel is held as OIHW
        self._buffer_of = {}
        for i, node in enumerate(self.nodes):
            if node["op"] != "Const":
                continue
            t = torch.from_numpy(np.array(weight_map[node["name"]]))
            if node["name"] in kernels:
                t = t.permute(3, 2, 0, 1).contiguous()
            self.register_buffer(f"const{i}", t.to(self.device), persistent=False)
            self._buffer_of[node["name"]] = f"const{i}"

    def const_values(self, name):
        """A Const's host values (shapes, axes, paddings)."""
        return np.asarray(self.weight_map[name]).tolist()

    def forward(self, images):
        values = {}  # node name → (tensor, held as NCHW)
        for node in self.nodes:
            values[node["name"]] = self._run(node, values, images)
        outs = []
        for name in self.output_names:
            t, nchw = values[name]
            outs.append(t.permute(0, 2, 3, 1) if nchw else t)
        return sorted(outs, key=lambda o: o.shape[1])

    @torch.inference_mode()
    def run_numpy(self, images):
        """numpy NHWC images → the heads as numpy arrays (13-grid first)."""
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)
        return [o.cpu().numpy() for o in self(x)]

    def _run(self, node, values, images):
        op = node["op"]
        inputs = node.get("input", [])
        if op == "Placeholder":
            return images.to(self.device, torch.float32).permute(0, 3, 1, 2), True
        if op == "Const":
            return getattr(self, self._buffer_of[node["name"]]), False
        x, nchw = values[inputs[0]] if inputs else (None, False)
        if op == "Identity":
            return x, nchw
        if op == "Conv2D":
            return self._conv2d(node, x, getattr(self, self._buffer_of[inputs[1]])), True
        if op == "BiasAdd":
            bias = values[inputs[1]][0]
            return x + (bias.view(1, -1, 1, 1) if nchw else bias), nchw
        if op == "LeakyRelu":
            return F.leaky_relu(x, float(node["attr"].get("alpha", {}).get("f", 0.2))), nchw
        if op in ("Add", "AddV2"):
            y, y_nchw = values[inputs[1]]
            if y_nchw != nchw:
                raise ValueError(f"{node['name']}: operands in different layouts")
            return x + y, nchw
        if op == "Pad":
            (n0, n1), (h0, h1), (w0, w1), (c0, c1) = self.const_values(inputs[1])
            if not nchw:
                raise ValueError(f"{node['name']}: Pad of a tensor that is not 4-D")
            return F.pad(x, (w0, w1, h0, h1, c0, c1, n0, n1)), True
        if op == "MaxPool":
            return self._max_pool(node, x), True
        if op == "ConcatV2":
            parts = [values[i] for i in inputs[:-1]]
            axis = int(self.const_values(inputs[-1]))
            if all(p[1] for p in parts):
                return torch.cat([p[0] for p in parts], dim=_NHWC_TO_NCHW[axis % 4]), True
            return torch.cat([p[0] for p in parts], dim=axis), False
        if op == "Reshape":
            shape = self.const_values(inputs[1])
            return (x.permute(0, 2, 3, 1) if nchw else x).reshape(shape), False
        if op == "ResizeNearestNeighbor":
            if _attr_bool(node, "align_corners") or _attr_bool(node, "half_pixel_centers"):
                raise ValueError(f"{node['name']}: only align_corners = half_pixel_centers "
                                 "= false (TF1 nearest) is supported")
            return F.interpolate(x, size=tuple(self.const_values(inputs[1])),
                                 mode="nearest"), True
        raise ValueError(f"{node['name']}: op {op} has no executor")

    @staticmethod
    def _check_nhwc(node):
        if "data_format" in node["attr"] and _attr_str(node, "data_format") != "NHWC":
            raise ValueError(f"{node['name']}: only NHWC graphs are supported")

    def _conv2d(self, node, x, kernel):
        self._check_nhwc(node)
        _, sh, sw, _ = _attr_ints(node, "strides")
        if any(d != 1 for d in _attr_ints(node, "dilations")):
            raise ValueError(f"{node['name']}: dilated convolutions are not supported")
        padding = _attr_str(node, "padding")
        kh, kw = kernel.shape[2:]
        if padding == "SAME":
            (t, b), (l, r) = (_same_pads(x.shape[2], kh, sh), _same_pads(x.shape[3], kw, sw))
            if t == b and l == r:
                return F.conv2d(x, kernel, stride=(sh, sw), padding=(t, l))
            x = F.pad(x, (l, r, t, b))
        elif padding != "VALID":
            raise ValueError(f"{node['name']}: padding {padding} is not supported")
        return F.conv2d(x, kernel, stride=(sh, sw))

    def _max_pool(self, node, x):
        self._check_nhwc(node)
        _, kh, kw, _ = _attr_ints(node, "ksize")
        _, sh, sw, _ = _attr_ints(node, "strides")
        padding = _attr_str(node, "padding")
        if padding == "SAME":
            (t, b), (l, r) = (_same_pads(x.shape[2], kh, sh), _same_pads(x.shape[3], kw, sw))
            x = F.pad(x, (l, r, t, b), value=float("-inf"))
        elif padding != "VALID":
            raise ValueError(f"{node['name']}: padding {padding} is not supported")
        return F.max_pool2d(x, (kh, kw), stride=(sh, sw))


def run_graph_model(model_dir: str, images, device=None):
    """Execute an exported graph-model → its heads as numpy arrays, sorted
    13-grid first like the js port (js/src/inference.js:46). Runs on the card
    unless ``device="cpu"``."""
    return GraphModel(model_dir, device=device).run_numpy(images)
