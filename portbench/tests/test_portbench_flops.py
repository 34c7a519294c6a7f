"""The yardstick's FLOP count, walked over the plain reference's shapes,
gives the published 65.86 (YOLOv3) and 5.56 (YOLOv3-tiny) GFLOP an image
at 416²."""

import os

import pytest

from portbench.flops import forward_flops, layer_table
from portbench.reference.graph import conv_shapes, load_graph

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("model,gflop,convs,params", [("yolov3", 65.864, 75, 61949149),
                                                     ("yolov3_tiny", 5.565, 13, 8852366)])
def test_flops_convs_and_params(model, gflop, convs, params):
    graph = load_graph(os.path.join(ROOT, f"config/models/{model}/model.yaml"), 80)
    table = layer_table(graph, 80, 416)
    assert round(forward_flops(table) / 1e9, 3) == gflop
    shapes = conv_shapes(graph)
    assert len(shapes) == convs
    bn = {key for key, e in table.items() if e["kind"] == "convolutional" and e["bn"]}
    total = sum(co * ci * k * k + (2 * co if key in bn else co)
                for key, (co, ci, k) in shapes.items())
    assert total == params
