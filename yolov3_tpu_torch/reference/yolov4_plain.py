"""Plain PyTorch YOLOv4 in float32: the forward and decode the port's YOLOv4
is held to.

YOLOv4 (Bochkovskiy, Wang, Liao, arXiv:2004.10934), as Darknet's
``cfg/yolov4.cfg`` (AlexeyAB/darknet) defines it and
``config/models/yolov4/`` spells it: CSPDarknet53 with Mish, SPP, a PAN neck
with LeakyReLU, three heads with ``scale_x_y``. This module reads the model
YAML itself and imports nothing of the port (no spec parser, no layer, no
kernel) and nothing of JAX. Its equations:

  * convolution: stride 1 pads ``(k-1)//2`` before and the rest after,
    stride 2 one row and column before and none after (Darknet's, on the
    even sizes a YOLOv4 input gives); then BatchNorm as inference computes
    it, ``(y − mean)·gamma/sqrt(var + 1e-3) + beta``, written out (not
    folded into the kernel), or the bias;
  * Mish ``v·tanh(softplus(v))`` with softplus ``v`` above 20 and
    ``log1p(exp(v))`` below (``F.softplus``'s threshold 20), not ATen's
    ``mish``; LeakyReLU ``v`` or ``0.1·v``;
  * shortcut: the sum; route: its sources concatenated on the channels in
    order (the listed layers, then the sub-model's inputs); upsample:
    nearest; maxpool: ``same`` padding with minus infinity;
  * decode: ``b_xy = (σ(t_xy)·s − (s − 1)/2 + c_xy) / g`` with the head's
    ``scale_x_y`` s, ``b_wh = a·exp(t_wh)``, objectness and class
    probabilities by sigmoid, corners (xmin, ymin, xmax, ymax);
  * suppression: greedy, class-agnostic, over the top ``candidates`` by
    score (a stable sort), a candidate above the score threshold kept unless
    a kept one overlaps it by an IoU above the threshold.

Departures from Darknet, each within float32 rounding of it:

  * Darknet's softplus is ``exp(v)`` below −20; ``log1p(exp(v))`` there
    differs from ``exp(v)`` by under exp(v)²/2, below float32's resolution
    of exp(v) itself, and ``v·tanh(·)`` follows it;
  * Darknet adds ``1e-6`` under the BatchNorm square root (``.000001``)
    where this model, trained by the Keras stack it comes from, takes
    epsilon 1e-3 (``models/layers.py::BN_EPS``);
  * Darknet pads a stride-2 convolution by one on every side and floors the
    output size; on even inputs the bottom and right pad is never read,
    which is the top-left pad here.

Call ``ieee_fp32()`` first on a card: TF32 off for convolutions and matmuls.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
import yaml

BN_EPS = 1e-3
LEAKY = 0.1
SOFTPLUS_THRESHOLD = 20.0


def ieee_fp32():
    """Convolutions and matmuls on the card in IEEE float32, never TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if hasattr(torch.backends.cudnn, "conv"):
        torch.backends.cudnn.conv.fp32_precision = "ieee"
        torch.backends.cuda.matmul.fp32_precision = "ieee"


def _filters(value, nclasses: int) -> int:
    if isinstance(value, int):
        return value
    # the heads' '3*(2+2+1+nclasses)'
    if value.replace(" ", "") != "3*(2+2+1+nclasses)":
        raise ValueError(f"unsupported filters expression {value!r}")
    return 3 * (5 + nclasses)


def load_graph(model_yaml: str, nclasses: int) -> list:
    """``model.yaml`` → [{"name", "layers", "inputs", "outputs"}] in file
    order, each layer a dict of its YAML keys (``filters`` evaluated)."""
    with open(model_yaml) as f:
        model = yaml.safe_load(f)
    model_dir = os.path.dirname(os.path.abspath(model_yaml))
    graph = []
    for sub in model["sub_models_configs"]:
        path = sub["layers_config_file"]
        if not os.path.exists(path):
            path = os.path.join(model_dir, os.path.basename(path))
        with open(path) as f:
            layers = [dict(layer) for layer in yaml.safe_load(f)["layers_config"]]
        for layer in layers:
            if layer["type"] == "convolutional":
                layer["filters"] = _filters(layer["filters"], nclasses)
        inputs = sub.get("inputs")
        outputs = sub["outputs_layers"]
        graph.append({"name": sub["name"], "layers": layers,
                      "inputs": None if not inputs else [(e["name"], int(e.get("entry_index", 0)))
                                                         for e in inputs["source"]],
                      "outputs": list(outputs) if isinstance(outputs, list) else [outputs]})
    return graph


def head_scales(graph) -> list:
    """Each head's ``scale_x_y`` in head order (1 where none is stated)."""
    return [float(layer.get("scale_x_y", 1.0)) for sm in graph for layer in sm["layers"]
            if layer["type"] == "yolo"]


def mish(v):
    return v * torch.tanh(F.softplus(v, beta=1.0, threshold=SOFTPLUS_THRESHOLD))


def leaky(v):
    return torch.where(v >= 0, v, v * LEAKY)


def activate(v, activation: str):
    if activation == "mish":
        return mish(v)
    if activation == "leaky":
        return leaky(v)
    if activation == "linear":
        return v
    raise ValueError(f"unknown activation {activation!r}")


def _conv(x, kernel, stride: int, pad: int):
    k = kernel.shape[2]
    if stride > 1:
        top, bottom = 1, 0
    elif pad:
        top, bottom = (k - 1) // 2, k - 1 - (k - 1) // 2
    else:
        top = bottom = 0
    return F.conv2d(F.pad(x, (top, bottom, top, bottom)), kernel, stride=stride)


def _maxpool(x, layer):
    (k, _), (s, _) = layer["size_xy"], layer["stride_xy"]
    if str(layer.get("padding", "valid")).lower() == "same":
        pads = []
        for dim in (x.shape[3], x.shape[2]):
            total = max((-(-dim // s) - 1) * s + k - dim, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, k, s)


def forward(graph, params, state, images, nclasses: int, batch_stats=None):
    """``images`` (B, H, W, 3) → the heads' raw outputs in head order, each
    (B, g, g, 3, 5 + classes), in float32. ``params`` / ``state``: the
    port's nested dicts (``params[sm]["layer<i>"] = {"kernel" OIHW, "bn":
    {"gamma", "beta"}}`` or ``{"kernel", "bias"}``, ``state[sm]["layer<i>"]
    = {"mean", "var"}``). ``batch_stats``: a dict that, when given, makes
    every BatchNorm normalize with the batch's mean and biased variance and
    receives them under ``(sm, "layer<i>")`` (running statistics for
    seeded weights)."""
    produced, heads = {}, []
    x0 = images.float().permute(0, 3, 1, 2)
    for sm in graph:
        inputs = [x0] if sm["inputs"] is None else [produced[n][j] for n, j in sm["inputs"]]
        x, outs = inputs[0], []
        for i, layer in enumerate(sm["layers"]):
            kind = layer["type"]
            if kind == "convolutional":
                entry = params[sm["name"]][f"layer{i}"]
                y = _conv(x, entry["kernel"].float(), int(layer["stride"]), int(layer.get("pad", 1)))
                if "bn" in entry:
                    if batch_stats is not None:
                        var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
                        batch_stats[(sm["name"], f"layer{i}")] = {"mean": mean, "var": var}
                    else:
                        st = state[sm["name"]][f"layer{i}"]
                        mean, var = st["mean"].float(), st["var"].float()
                    bn = entry["bn"]
                    y = ((y - mean.view(1, -1, 1, 1)) * (bn["gamma"].float() / torch.sqrt(
                        var + BN_EPS)).view(1, -1, 1, 1) + bn["beta"].float().view(1, -1, 1, 1))
                else:
                    y = y + entry["bias"].float().view(1, -1, 1, 1)
                x = activate(y, layer.get("activation", "linear"))
            elif kind == "shortcut":
                x = outs[int(layer["from"])] + x
            elif kind == "route":
                src = layer["source"]
                parts = ([outs[j] for j in src.get("layers", [])]
                         + [inputs[j] for j in src.get("inputs", [])])
                x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            elif kind == "upsample":
                s = int(layer["stride"])
                x = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
            elif kind == "maxpool":
                x = _maxpool(x, layer)
            elif kind == "yolo":
                b, _, h, w = x.shape
                x = x.permute(0, 2, 3, 1).reshape(b, h, w, 3, 5 + nclasses)
                heads.append(x)
            else:
                raise ValueError(f"unknown layer type {kind}")
            outs.append(x)
        produced[sm["name"]] = [outs[j] for j in sm["outputs"]]
    return heads


def running_state(graph, params, images, nclasses: int) -> dict:
    """BatchNorm statistics of a forward over ``images``, each layer
    normalized by its own batch's: the port's ``state`` layout."""
    stats = {}
    with torch.no_grad():
        forward(graph, params, None, images, nclasses, batch_stats=stats)
    state = {}
    for (sm, key), st in stats.items():
        state.setdefault(sm, {})[key] = {"mean": st["mean"].clone(), "var": st["var"].clone()}
    return state


def decode(heads, anchors, nclasses: int, scales):
    """heads (B, g, g, 3, 5 + nc) in head order; anchors (S, 3, 2) over the
    input size; scales: each head's ``scale_x_y`` → boxes (B, N, 4),
    objectness (B, N), class probabilities (B, N, nc)."""
    boxes, conf, probs = [], [], []
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=heads[0].device)
    for out, anc, s in zip(heads, anchors, scales):
        b, gh, gw = out.shape[:3]
        t = out.float()
        row, col = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=t.device),
                                  torch.arange(gw, dtype=torch.float32, device=t.device),
                                  indexing="ij")
        cells = torch.stack([col, row], dim=-1)[None, :, :, None, :]
        grid = torch.tensor([gw, gh], dtype=torch.float32, device=t.device)
        centre = (torch.sigmoid(t[..., 0:2]) * s - (s - 1.0) / 2.0 + cells) / grid
        wh = torch.exp(t[..., 2:4]) * anc
        boxes.append(torch.cat([centre - wh / 2.0, centre + wh / 2.0], -1).reshape(b, -1, 4))
        conf.append(torch.sigmoid(t[..., 4]).reshape(b, -1))
        probs.append(torch.sigmoid(t[..., 5:]).reshape(b, -1, nclasses))
    return torch.cat(boxes, 1), torch.cat(conf, 1), torch.cat(probs, 1)


def _iou(a, b):
    lt = torch.maximum(a[:2], b[:, :2])
    rb = torch.minimum(a[2:], b[:, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[:, 0] * wh[:, 1]
    area_a = torch.clamp(a[2] - a[0], min=0.0) * torch.clamp(a[3] - a[1], min=0.0)
    area_b = torch.clamp(b[:, 2] - b[:, 0], min=0.0) * torch.clamp(b[:, 3] - b[:, 1], min=0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms(boxes, scores, max_boxes: int, iou_threshold: float, score_threshold: float,
        candidates: int):
    """Greedy suppression per image → [the selected candidates' indices]."""
    out = []
    for b in range(scores.shape[0]):
        order = torch.argsort(-scores[b], stable=True)[:candidates]
        kept = []
        for i in order.tolist():
            if len(kept) == max_boxes or not scores[b, i] > score_threshold:
                continue
            if kept and bool((_iou(boxes[b, i], boxes[b, kept]) > iou_threshold).any()):
                continue
            kept.append(i)
        out.append(kept)
    return out
