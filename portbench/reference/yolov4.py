"""Plain PyTorch YOLOv4 in float32: what the YOLOv4 cell is judged by.

YOLOv4 (Bochkovskiy, Wang, Liao, arXiv:2004.10934; Darknet's
``cfg/yolov4.cfg``) as ``config/models/yolov4/`` spells it runs through
``model.py``'s graph walk (``run_graph``: convolution padding, BatchNorm
folded, shortcut, route of any number of sources, upsample, ``same``
max-pool, heads) with two changes of its own:

  * Mish after a convolution that states it, written out as
    ``v·tanh(softplus(v))`` with softplus ``v`` above 20 and
    ``log1p(exp(v))`` below (Darknet's is ``exp(v)`` below −20, equal in
    float32 there); ``model.py``'s ops would run such a layer as linear;
  * the decode of a head with ``scale_x_y`` s: ``b_xy = (σ(t_xy)·s −
    (s − 1)/2 + c_xy) / g``, ``b_wh = a·exp(t_wh)``.

``mish_as="leaky"`` runs every Mish layer as LeakyReLU: the control that a
port computing the wrong activation fails. Nothing here imports the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .model import BN_EPS, FloatOps, TrainOps, darknet_conv, leaky

SOFTPLUS_THRESHOLD = 20.0


def mish(v):
    return v * torch.tanh(F.softplus(v, beta=1.0, threshold=SOFTPLUS_THRESHOLD))


def _activate(y, layer, mish_as):
    activation = layer.get("activation", "linear")
    if activation == "mish":
        activation = mish_as
    if activation == "mish":
        return mish(y)
    return leaky(y) if activation == "leaky" else y


class MishFloatOps(FloatOps):
    """``FloatOps`` (inference over folded convolutions) with Mish."""

    def __init__(self, folded, nclasses: int, rounding=None, mish_as: str = "mish"):
        super().__init__(folded, nclasses, rounding)
        self.mish_as = mish_as

    def conv(self, key, layer, x):
        kernel, bias = self.folded[key]
        if self.rounding is not None:
            x, kernel = self.rounding.activation(x), self.rounding.weight(kernel)
        y = darknet_conv(x, kernel, int(layer["stride"]), int(layer.get("pad", 1)))
        if self.rounding is not None:
            y = self.rounding.output(y)
        return _activate(y + bias.view(1, -1, 1, 1), layer, self.mish_as)


class MishTrainOps(TrainOps):
    """``TrainOps`` (BatchNorm over the batch's statistics, recorded in
    ``new_state``) with Mish."""

    def conv(self, key, layer, x):
        sm, i = key
        entry = self.params[sm][f"layer{i}"]
        y = darknet_conv(x, entry["kernel"], int(layer["stride"]), int(layer.get("pad", 1)))
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
        return _activate(y, layer, "mish")


def head_scales(graph) -> list:
    """Each head's ``scale_x_y`` in head order (1 where none is stated)."""
    return [float(layer.get("scale_x_y", 1.0)) for sm in graph for layer in sm["layers"]
            if layer["type"] == "yolo"]


def decode(heads, anchors, nclasses: int, scales):
    """heads: (B, g, g, 3, 5 + nc) each, in head order; anchors (S, 3, 2);
    scales: each head's ``scale_x_y`` → boxes (B, N, 4), objectness (B, N),
    class probabilities (B, N, nc)."""
    boxes, conf, probs = [], [], []
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=heads[0].device)
    for out, anc, s in zip(heads, anchors, scales):
        b, gh, gw = out.shape[:3]
        g = out.float()
        row, col = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=g.device),
                                  torch.arange(gw, dtype=torch.float32, device=g.device),
                                  indexing="ij")
        cells = torch.stack([col, row], dim=-1)[None, :, :, None, :]
        grid = torch.tensor([gw, gh], dtype=torch.float32, device=g.device)
        centre = (torch.sigmoid(g[..., 0:2]) * s - (s - 1.0) / 2.0 + cells) / grid
        wh = torch.exp(g[..., 2:4]) * anc
        boxes.append(torch.cat([centre - wh / 2.0, centre + wh / 2.0], -1).reshape(b, -1, 4))
        conf.append(torch.sigmoid(g[..., 4]).reshape(b, -1))
        probs.append(torch.sigmoid(g[..., 5:]).reshape(b, -1, nclasses))
    return torch.cat(boxes, 1), torch.cat(conf, 1), torch.cat(probs, 1)


def candidate_cells(heads):
    """Each candidate's grid size (N,) and cell (N, 2) as (column, row), in
    the decode's order."""
    grids, cells = [], []
    for h in heads:
        gh, gw, na = h.shape[1:4]
        row, col = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=h.device),
                                  torch.arange(gw, dtype=torch.float32, device=h.device),
                                  indexing="ij")
        cells.append(torch.stack([col, row], -1)[:, :, None, :].expand(gh, gw, na, 2)
                     .reshape(-1, 2))
        grids.append(torch.full((gh * gw * na,), float(gw), device=h.device))
    return torch.cat(grids), torch.cat(cells)
