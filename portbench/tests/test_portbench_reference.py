"""The plain reference agrees with the port on the CPU at a small size: the
float32 forward, the int8_chain lattice (calibration, quantization, the
requant chain), decode, suppression and one training step's loss, first
gradient and Adam update."""

import os

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.judge import compare_train
from portbench.reference import detect as RD
from portbench.reference import int8 as R8
from portbench.reference import train as RT
from portbench.reference.graph import decay_factor, load_graph
from portbench.reference.model import FloatOps, fold_bn, run_graph
from portbench.weights import make_weights

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SIZE = 64


def model(name):
    path = os.path.join(ROOT, f"config/models/{name}/model.yaml")
    from yolov3_tpu_torch.models import parse_model_config

    return path, load_graph(path, 80), parse_model_config(path, 80)


def anchors(n):
    return np.abs(np.random.RandomState(0).randn(n, 3, 2)).astype(np.float32) * 0.2 + 0.05


@pytest.mark.parametrize("name", ["yolov3_tiny", "yolov3"])
def test_float_forward_equals_the_port(name):
    from yolov3_tpu_torch.models import apply_model, fold_batch_norm

    _, graph, spec = model(name)
    params, state = make_weights(graph, 80, 11, SIZE, "cpu")
    x = torch.rand(2, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = run_graph(graph, x, FloatOps(fold_bn(params, state), 80))
        port = apply_model(spec, fold_batch_norm(params, state), {}, x)
    for r, p in zip(ref, port):
        assert torch.equal(r, p)


def test_int8_chain_decode_and_nms_equal_the_port():
    from yolov3_tpu_torch.apps.inference_app import make_predictor

    _, graph, spec = model("yolov3")
    params, state = make_weights(graph, 80, 12, SIZE, "cpu")
    calib = traffic.calibration_images(12, 4, SIZE, "cpu")
    table = anchors(3)
    predict = make_predictor(spec, params, state, table, 80, 100, 0.5, 0.3,
                             quantize="int8_chain", calibration_batches=[calib], image_size=SIZE,
                             device="cpu")
    x = traffic.derived(traffic.image_pool(12, 1, 3, SIZE, "cpu"), 5)
    bboxes, classes, scores, selected, num_valid = predict(x)
    qm = R8.int8_model(graph, params, state, 80, torch.from_numpy(calib))
    with torch.no_grad():
        boxes, conf, probs = RD.decode(run_graph(graph, x, R8.Int8Ops(qm, 80)), table, 80)
    ref_scores, ref_classes = RD.scores_classes(conf, probs)
    assert float((ref_scores - scores).abs().max()) < 1e-5
    assert float(((boxes - bboxes).abs() / (1 + boxes.abs())).max()) < 1e-5
    sel, nv = RD.nms(bboxes, scores, 100, 0.5, 0.3, 512)
    assert torch.equal(nv, num_valid.long())
    for b in range(x.shape[0]):
        assert torch.equal(sel[b, :nv[b]], selected[b, :nv[b]].long())


def test_decode_and_nms_equal_the_port_on_random_heads():
    from yolov3_tpu_torch.ops.decode import yolo_decode
    from yolov3_tpu_torch.ops.nms import yolo_nms

    g = torch.Generator().manual_seed(3)
    heads = [torch.randn(2, s, s, 3, 85, generator=g) * 2 for s in (4, 8)]
    table = anchors(2)
    b_p, c_p, p_p = yolo_decode(heads, table, 80)
    b_r, c_r, p_r = RD.decode(heads, table, 80)
    assert torch.allclose(b_p, b_r, atol=1e-6) and torch.allclose(c_p[..., 0], c_r, atol=1e-7)
    out = yolo_nms(b_p, c_p, p_p, 20, 0.5, 0.2)
    scores, classes = RD.scores_classes(c_p[..., 0], p_p)
    assert torch.equal(scores, out[2]) and torch.equal(classes, out[1])
    sel, nv = RD.nms(b_p, out[2], 20, 0.5, 0.2, 512)
    assert torch.equal(nv, out[4].long()) and torch.equal(sel, out[3].long())


def test_train_steps_equal_the_ports_in_float32():
    from yolov3_tpu_torch.models.network import head_grid_sizes
    from yolov3_tpu_torch.parallel.train_step import init_train_state, make_adam, make_train_step

    path, graph, spec = model("yolov3_tiny")
    params, state = make_weights(graph, 80, 13, SIZE, "cpu")
    cell = {"boxes_per_image": [1, 20], "box_side": [0.02, 0.8]}
    pool = traffic.image_pool(13, 2, 4, SIZE, "cpu")
    labels = traffic.label_pool(13, 2, 4, cell, 80, "cpu")
    batches = [(traffic.derived(pool, j), labels[j % 2]) for j in range(3)]
    table = anchors(2)
    opt = make_adam(1e-3)
    step = make_train_step(spec, table, head_grid_sizes(spec, SIZE), 4, opt)
    ts = init_train_state(params, state, opt)
    losses = []
    for j, (x, y) in enumerate(batches):
        ts, m = step(ts, x, y)
        losses.append(float(m["total_loss"]))
        if j == 0:
            g1 = {k: v / 0.1 for k, v in RT.leaves(ts["opt_state"]["mu"]).items()}
            s1 = RT.leaves(ts["bn_state"])
    port = {"losses": losses, "grad1": g1, "state1": s1, "params": RT.leaves(ts["params"]),
            "state": RT.leaves(ts["bn_state"])}
    ref = RT.adam_steps(graph, params, state, 80, torch.from_numpy(table), batches, 1e-3,
                        decay_factor(path))
    numbers = compare_train(RT.leaves(params), RT.leaves(state), port, ref)
    # the first step from equal weights agrees to float32's rounding; the
    # later ones drift as float32 training does (an update's sign flips
    # where a gradient is near zero)
    assert numbers["loss1_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4
    assert numbers["bn1_gap"] < 1e-4
    assert numbers["loss_gap"] < 1e-2 and numbers["change_median_gap"] < 1e-2
