"""The work of a forward, counted from the plain reference's shapes.

``layer_table`` walks the reference graph on the ``meta`` device (shapes
only, no arithmetic) and gives every layer's input and output shape and
every convolution's kernel and multiply-accumulates for ONE image. A
model's FLOPs are ``2 · Σ MACs``: 65.864 GFLOP for YOLOv3 at 416² and 5.565
for YOLOv3-tiny, the published 65.86 and 5.56 (Darknet's ``yolov3.cfg`` and
``yolov3-tiny.cfg`` at 416). A training step counts three forwards' worth
(the forward, and the backward's two products a conv).
"""

from __future__ import annotations

import torch

from .reference.graph import conv_shapes
from .reference.model import FloatOps, run_graph


def layer_table(graph, nclasses: int, image_size: int) -> dict:
    """{(sm, i): {"kind", "in": (C, H, W) | None, "out": (C, H, W) | None,
    "macs", and for a conv "cout", "cin", "k", "bn"}}, one image."""
    shapes = conv_shapes(graph)
    folded = {key: (torch.empty((co, ci, k, k), device="meta"), torch.empty((co,), device="meta"))
              for key, (co, ci, k) in shapes.items()}
    layers = {(sm["name"], i): layer for sm in graph for i, layer in enumerate(sm["layers"])}
    table = {}

    def observe(key, kind, x_in, x_out):
        entry = {"kind": kind, "in": tuple(x_in.shape[1:]) if x_in.dim() == 4 else None,
                 "out": tuple(x_out.shape[1:]) if x_out.dim() == 4 else None, "macs": 0}
        if kind == "convolutional":
            co, ci, k = shapes[key]
            entry.update(cout=co, cin=ci, k=k, bn=bool(layers[key].get("batch_normalize")),
                         macs=entry["out"][1] * entry["out"][2] * co * ci * k * k)
        table[key] = entry

    run_graph(graph, torch.empty((1, image_size, image_size, 3), device="meta"),
              FloatOps(folded, nclasses), observer=observe)
    return table


def forward_flops(table) -> float:
    """2 · MACs of one image's forward."""
    return 2.0 * sum(e["macs"] for e in table.values())
