"""The YOLOv4 cell's files, its reference and its reader, on the CPU: the
FLOP walk gives the published count; the benchmark's YOLOv4 reference
agrees with the port's own plain reference (``yolov3_tpu_torch/reference/
yolov4_plain.py``) on seeded weights; the check reads nothing on the
reference's own outputs and sees the ``scale_x_y`` control; a small run of
the cell passes by the cell's limits and each control and fault of the mode
(``STAND_INS``) fails by them; ``mish_ms.infer`` reads only kernels named
``mish``."""

import json
import os
import types

import pytest
import torch

from portbench import judge
from portbench import run as R
from portbench.flops import forward_flops, layer_table
from portbench.modes import infer_yolov4 as M
from portbench.records import Records, reader
from portbench.reference import detect as RD
from portbench.reference import yolov4 as R4
from portbench.reference.graph import conv_shapes, load_graph
from portbench.reference.model import run_graph
from portbench.weights import make_weights

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "yolov4-608.infer_bf16_b64"
SIZE = 96
SEED = 2**31 + 99


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def setup():
    config = _json("portbench", "configs", "yolov4-608.json")
    graph = load_graph(os.path.join(ROOT, config["model"]), 80)
    params, state = M.make_weights(graph, 80, 2**31 + 11, SIZE, torch.device("cpu"))
    return dict(config=config, graph=graph, params=params, state=state)


def test_flops_convs_and_params_at_608():
    config = _json("portbench", "configs", "yolov4-608.json")
    graph = load_graph(os.path.join(ROOT, config["model"]), 80)
    table = layer_table(graph, 80, 608)
    assert round(forward_flops(table) / 1e9, 2) == config["published"]["gflops_per_image"]
    shapes = conv_shapes(graph)
    assert len(shapes) == config["published"]["convolutions"] == 110
    bn = {key for key, e in table.items() if e["kind"] == "convolutional" and e["bn"]}
    total = sum(co * ci * k * k + (2 * co if key in bn else co)
                for key, (co, ci, k) in shapes.items())
    assert total == config["published"]["params"]
    assert [e["in"][1] for e in table.values() if e["kind"] == "yolo"] == [76, 38, 19]


def test_cell_files_load():
    cell = _json("portbench", "workloads", f"{CELL}.json")
    config = _json("portbench", "configs", f"{cell['config']}.json")
    bench = _json("BENCHMARK.json")
    assert cell["mode"] == "infer_yolov4" and cell["tier"] == "bf16" and cell["batch"] == 64
    assert judge.anchors(config).shape == (3, 3, 2)
    # the anchors in head order: the 76-grid head's are the smallest
    sizes = judge.anchors(config).prod(-1).max(-1)
    assert list(sizes) == sorted(sizes)
    assert config["reduced"] == [] and config["image_size"] == 608
    assert any(w["name"] == CELL for w in bench["workloads"])
    metric = next(m for m in bench["per_layer"] if m["name"] == "mish_ms.infer")
    assert metric["workloads"] == [CELL]


def test_the_reference_is_the_ports_plain_reference(setup):
    from yolov3_tpu_torch.reference import yolov4_plain as P

    s = setup
    plain_graph = P.load_graph(os.path.join(ROOT, s["config"]["model"]), 80)
    images = torch.rand((2, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ours = run_graph(s["graph"], images, M.reference_ops(s["graph"], s["params"], s["state"],
                                                             s["config"]))
        theirs = P.forward(plain_graph, s["params"], s["state"], images, 80)
        # folded against unfolded BatchNorm: float32 rounding through 110 layers
        for a, b in zip(ours, theirs):
            assert float((a - b).abs().max() / b.abs().max()) < 2e-3
        table = judge.anchors(s["config"])
        got = R4.decode(theirs, table, 80, R4.head_scales(s["graph"]))
        want = P.decode(theirs, table, 80, P.head_scales(plain_graph))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        # the running statistics: the same Mish batch statistics
        ops = R4.MishTrainOps(s["params"], s["state"], 80, momentum=0.0)
        run_graph(s["graph"], images, ops)
        stats = P.running_state(plain_graph, s["params"], images, 80)
    # the same rounding carried through the layers before each
    for sm, layers in stats.items():
        for key, st in layers.items():
            for name in ("mean", "var"):
                gap = (ops.new_state[sm][key][name] - st[name]).abs().max()
                assert float(gap / st[name].abs().max()) < 2e-3, (sm, key, name)


def test_the_weights_statistics_are_mishs(setup):
    """``weights.make_weights`` walks ``model.py``'s ops (Mish run as
    linear); the mode's statistics are the Mish forward's."""
    s = setup
    _, base = make_weights(s["graph"], 80, 2**31 + 11, SIZE, torch.device("cpu"))
    key = ("backbone", "layer3")  # after two Mish layers
    assert not torch.allclose(s["state"][key[0]][key[1]]["mean"], base[key[0]][key[1]]["mean"])


def _samples(s, images, scales=None):
    ops = M.reference_ops(s["graph"], s["params"], s["state"], s["config"])
    boxes, conf, probs, _, _ = M.decoded(s["graph"], ops, s["config"], images, scales)
    scores, classes = RD.scores_classes(conf, probs)
    nms = _json("portbench", "workloads", f"{CELL}.json")["nms"]
    sel, nv = RD.nms(boxes, scores, nms["max_boxes"], nms["iou_threshold"],
                     nms["score_threshold"], nms["candidates"])
    out = (boxes, classes, scores, sel, nv)
    return [(0, out, tuple(t.cpu() for t in RD.gather(*out)))]


def test_the_check_reads_nothing_on_the_reference_and_sees_scale_x_y(setup):
    s = setup
    cell = _json("portbench", "workloads", f"{CELL}.json")
    images = torch.rand((2, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        sound = M.judge_yolov4(s["graph"], s["params"], s["state"], s["config"], cell,
                               lambda i: images, _samples(s, images), torch.device("cpu"))
        scale_one = M.judge_yolov4(s["graph"], s["params"], s["state"], s["config"], cell,
                                   lambda i: images, _samples(s, images, [1.0] * 3),
                                   torch.device("cpu"))
    assert all(v == 0 for v in sound.values()), sound
    assert scale_one["centre_drift_image_gap"] > 0.01 and scale_one["score_image_gap"] == 0


def test_the_stand_ins_by_the_cells_limits(monkeypatch):
    """The cell at a batch of 4 from two pool batches, at 96²: the sound run
    passes by the cell's limits, and every fault and float32 control fails
    by them; the float8 control reads at least three times what the sound
    run reads in one compared number (the limits hold at 608, where the card
    reads them)."""
    from portbench.modes import infer

    monkeypatch.setattr(infer, "POOL_BATCHES", 2)
    cell = dict(_json("portbench", "workloads", f"{CELL}.json"), batch=4)
    config = dict(_json("portbench", "configs", f"{cell['config']}.json"), image_size=SIZE)
    ctx = R.Context(CELL, SEED, 0.5, 0, "cpu", config=config, cell=cell)
    M.run(ctx)
    read = {name: M.check(ctx, M.stand_in(ctx, ctx.evidence, name)) for name in M.STAND_INS}
    correct = {name: R.verdict(cell["limits"], numbers)[0] for name, numbers in read.items()}
    assert correct["none"], read["none"]
    for name in ("leaky_for_mish", "scale_x_y_one", "half_batch", "one_image"):
        assert not correct[name], (name, read[name])
    sound, low = read["none"], read["lower_precision"]
    assert any(low[n] > 0 and low[n] >= 3 * sound[n] for n in cell["limits"]), (low, sound)


def test_mish_ms_reads_only_mish_kernels():
    read = reader("mish_ms.infer")
    rec = Records({}, {}, {}, 64, {}, {}, None)
    assert read(rec) is None
    trace = types.SimpleNamespace(units=2, attributed=[
        ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous "
         "namespace)::mish_kernel(at::TensorIteratorBase&)>", 3000.0, "L|backbone|layer1|x", None),
        ("sm90_xmma_fprop_implicit_gemm_bf16", 5000.0, "L|backbone|layer1|x", None)])
    rec.trace = trace
    assert read(rec) == 1.5
    trace.attributed = trace.attributed[1:]
    assert read(rec) is None
