"""YOLOv4 on the port (``config/models/yolov4/``) against its plain float32
reference (``yolov3_tpu_torch/reference/yolov4_plain.py``), on the CPU.

The model at its published widths (64,363,101 parameters, 110 convolutions)
on a small image, seeded weights: glorot kernels, BatchNorm gamma U(0.8,
1.2) and beta U(0.8, 1.2), head biases U(−0.2, 0.2), running statistics
from the reference's batch statistics over 4 seeded images (under a fresh
init's mean 0 / variance 1 the heads shrink to logits near 0 and nothing
tells the activations apart). Betas near 1 keep the pre-activations where
Mish and LeakyReLU are nearly linear: at betas near 0 the network's plain
chains of BatchNorm and activation grow a perturbation ~1.16× a layer, and
bf16's rounding reaches the heads' whole range (mean-field theory of
batch-normalized networks; PERF.md §6). Compared: the raw heads, the decode with
each head's ``scale_x_y``, and the serving predictor's NMS selection
(index-exact). Two controls on the same weights, Mish run as LeakyReLU and
``scale_x_y`` taken as 1, must fail the same tolerances. Every path that
cannot compute Mish raises and names the layer."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.apps.inference_app import make_predictor
from yolov3_tpu_torch.export.tfjs_graph import build_graph_topology
from yolov3_tpu_torch.models import network as tnet
from yolov3_tpu_torch.models.darknet_cfg import parse_darknet_cfg
from yolov3_tpu_torch.models.spec import LayerSpec, _attrs, parse_model_config
from yolov3_tpu_torch.ops.decode import yolo_decode
from yolov3_tpu_torch.parallel import train_step as tts
from yolov3_tpu_torch.reference import yolov4_plain as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "config/models/yolov4/model.yaml")
NC = 80
SIZE = 128
BATCH = 2
# yolov4.cfg's anchors over 608, in head order (the 76² head first)
ANCHORS = (np.asarray([12, 16, 19, 36, 40, 28, 36, 75, 76, 55, 72, 146, 142, 110, 192, 243,
                       459, 401], np.float32) / 608.0).reshape(3, 3, 2)
NMS = dict(max_boxes=100, iou_threshold=0.5, score_threshold=0.3, candidates=512)

# Tolerances, float32 port against float32 reference. The port folds
# BatchNorm into the kernel (kernel·s, beta − mean·s) and runs ATen's mish;
# the reference normalizes after the convolution and writes Mish out. Each
# layer differs by float32 rounding (~1e-7 relative), which 110 layers carry
# to 1.0e-5 of the heads' largest logit here (1.8e-5 at 608² on an H100,
# ``test_torch_yolov4_cuda.py``). A logit gap of δ moves a probability by at
# most δ/4, a centre by δ·s/(4·g) and a size by a factor e^δ. Each limit
# sits 3-20× above the port's readings on either (printed with -s) and far
# below the controls' (6e-3 and up).
HEAD_TOL = 1e-4      # max |port − reference| over max |reference|, each head
CENTRE_TOL = 5e-5    # max |box centre − reference's|, in image widths
SIZE_TOL = 1e-3      # max |log(box size / reference's)|
PROB_TOL = 1e-4      # max |objectness or class probability − reference's|


def seeded_model(size, batch, device="cpu"):
    """The spec, the reference's graph, seeded params and running statistics
    (see the module's doc), ``batch`` seeded images at ``size``², and the
    reference's heads and decode of them, on ``device``."""
    spec = parse_model_config(MODEL, NC)
    graph = ref.load_graph(MODEL, NC)
    g = torch.Generator().manual_seed(4)
    params, _ = tnet.init_model(spec, g)
    for sm_params in params.values():
        for entry in sm_params.values():
            if "bn" in entry:
                c = entry["bn"]["gamma"].shape[0]
                entry["bn"] = {"gamma": 0.8 + 0.4 * torch.rand(c, generator=g),
                               "beta": 0.8 + 0.4 * torch.rand(c, generator=g)}
            else:
                entry["bias"] = 0.4 * torch.rand(entry["bias"].shape, generator=g) - 0.2
    params = tnet.to_device(params, device)
    stats_images = torch.rand((4, size, size, 3), generator=g).to(device)
    state = ref.running_state(graph, params, stats_images, NC)
    images = torch.rand((batch, size, size, 3), generator=g).to(device)
    with torch.no_grad():
        heads = ref.forward(graph, params, state, images, NC)
        decoded = ref.decode(heads, ANCHORS, NC, ref.head_scales(graph))
    return dict(spec=spec, graph=graph, params=params, state=state, images=images,
                heads=heads, decoded=decoded)


@pytest.fixture(scope="module")
def v4():
    return seeded_model(SIZE, BATCH)


def _port_heads(v4, spec=None):
    folded = tnet.fold_batch_norm(v4["params"], v4["state"])
    with torch.no_grad():
        return tnet.apply_model(spec or v4["spec"], folded, {}, v4["images"])


def _head_gap(heads, want):
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(heads, want))


def _decode_gaps(decoded, want):
    """(centre gap, size gap, probability gap), see the tolerances."""
    boxes, conf, probs = decoded
    rb, rc, rp = want
    centre, ref_centre = (boxes[..., :2] + boxes[..., 2:]) / 2, (rb[..., :2] + rb[..., 2:]) / 2
    size = torch.log((boxes[..., 2:] - boxes[..., :2]) / (rb[..., 2:] - rb[..., :2]))
    return (float((centre - ref_centre).abs().max()), float(size.abs().max()),
            max(float((conf[..., 0] - rc).abs().max()), float((probs - rp).abs().max())))


def _with_activation(spec, old, new):
    """``spec`` with every ``old`` activation run as ``new`` (a control)."""
    def swap(layer):
        attrs = dict(layer.attrs)
        if layer.kind == "convolutional" and attrs.get("activation") == old:
            attrs["activation"] = new
        return LayerSpec(layer.kind, _attrs(attrs))

    return dataclasses.replace(spec, sub_models=tuple(
        dataclasses.replace(sm, layers=tuple(swap(layer) for layer in sm.layers))
        for sm in spec.sub_models))


def test_counts_grids_and_scales(v4):
    spec = v4["spec"]
    acts = [layer["activation"] for sm in spec.sub_models for layer in sm.layers
            if layer.kind == "convolutional"]
    assert (len(acts), acts.count("mish"), acts.count("leaky"), acts.count("linear")) == (
        110, 72, 35, 3)
    assert spec.activation_counts == {"linear": 3, "leaky": 35, "mish": 72}
    assert _with_activation(spec, "mish", "leaky").activation_counts == {
        "linear": 3, "leaky": 107, "mish": 0}
    assert tnet.param_count(v4["params"]) == 64_363_101
    assert tnet.head_grid_sizes(spec, 608) == (76, 38, 19)
    assert spec.head_scales() == (1.2, 1.1, 1.05)
    assert [sm.name for sm in spec.output_sub_models] == ["head0", "head1", "head2"]


def test_heads_and_decode_against_the_reference(v4):
    heads = _port_heads(v4)
    gap = _head_gap(heads, v4["heads"])
    centre, size, prob = _decode_gaps(yolo_decode(heads, ANCHORS, NC, v4["spec"].head_scales()),
                                      v4["decoded"])
    print(f"yolov4 port vs reference: heads {gap:.3g}, centres {centre:.3g}, sizes {size:.3g}, "
          f"probabilities {prob:.3g}")
    assert gap <= HEAD_TOL and centre <= CENTRE_TOL and size <= SIZE_TOL and prob <= PROB_TOL


def test_leaky_for_mish_fails_the_tolerance(v4):
    heads = _port_heads(v4, _with_activation(v4["spec"], "mish", "leaky"))
    gap = _head_gap(heads, v4["heads"])
    centre, size, prob = _decode_gaps(yolo_decode(heads, ANCHORS, NC, v4["spec"].head_scales()),
                                      v4["decoded"])
    print(f"control, leaky for mish: heads {gap:.3g}, centres {centre:.3g}, sizes {size:.3g}, "
          f"probabilities {prob:.3g}")
    assert gap > HEAD_TOL and centre > CENTRE_TOL and size > SIZE_TOL and prob > PROB_TOL


def test_scale_x_y_one_fails_the_tolerance(v4):
    centre, size, prob = _decode_gaps(yolo_decode(_port_heads(v4), ANCHORS, NC), v4["decoded"])
    print(f"control, scale_x_y 1: centres {centre:.3g}")
    assert centre > CENTRE_TOL


def test_predictor_selection_is_the_references(v4):
    predict = make_predictor(v4["spec"], v4["params"], v4["state"], ANCHORS, NC,
                             NMS["max_boxes"], NMS["iou_threshold"], NMS["score_threshold"],
                             image_size=SIZE, device="cpu")
    boxes, classes, scores, selected, num_valid = predict(v4["images"].numpy())
    rb, rc, rp = v4["decoded"]
    # the predictor's scores are the reference's within the decode's limit
    assert float((scores - rc * rp.max(-1).values).abs().max()) <= PROB_TOL
    # its selection is the reference's suppression over its own boxes and
    # scores, index for index (over the reference's boxes, a tie between two
    # scores within the forward's rounding may order them either way)
    want = ref.nms(boxes, scores, **NMS)
    got = [selected[b, :int(num_valid[b])].tolist() for b in range(BATCH)]
    assert all(got), "no detection survived: the comparison would be empty"
    assert got == want


@pytest.mark.parametrize("what", ["int8", "int8_chain"])
def test_int8_tiers_raise_on_mish(v4, what):
    with pytest.raises(NotImplementedError, match=r"backbone/layer1 has activation 'mish'"):
        make_predictor(v4["spec"], v4["params"], v4["state"], ANCHORS, NC, 100, 0.5, 0.3,
                       quantize=what, calibration_batches=[v4["images"].numpy()],
                       image_size=SIZE, device="cpu")


@pytest.mark.parametrize("what", ["make_train_step", "loss_and_grads"])
def test_training_raises_on_mish(v4, what):
    labels = torch.zeros((BATCH, 4, 6))
    labels[:, 0] = torch.tensor([0.2, 0.2, 0.6, 0.7, 1.0, 3.0])
    with pytest.raises(NotImplementedError, match=r"backbone/layer1 has activation 'mish'"):
        if what == "make_train_step":
            tts.make_train_step(v4["spec"], ANCHORS, (16, 8, 4), BATCH, tts.make_adam(1e-3))
        else:
            tts.loss_and_grads(v4["spec"], v4["params"], v4["state"], v4["images"], labels,
                               ANCHORS, (16, 8, 4), BATCH)


@pytest.mark.parametrize("what, match", [("mish", r"backbone/layer1 has activation 'mish'"),
                                         ("scale_x_y", r"head 0 has scale_x_y 1.2")])
def test_tfjs_export_raises(v4, what, match):
    """The browser computes LeakyReLU and YOLOv3's box equation: a Mish
    model, or a leaky one whose heads scale their centres, would export and
    be served wrong."""
    folded = tnet.fold_batch_norm(v4["params"], v4["state"])
    spec = v4["spec"] if what == "mish" else _with_activation(v4["spec"], "mish", "leaky")
    with pytest.raises(NotImplementedError, match=match):
        build_graph_topology(spec, folded, SIZE)


def test_darknet_cfg_mish_and_scale_x_y(tmp_path):
    path = tmp_path / "v4_fragment.cfg"
    path.write_text("\n".join([
        "[net]", "width=64", "height=64", "",
        "[convolutional]", "batch_normalize=1", "filters=8", "size=3", "stride=2", "pad=1",
        "activation=mish", "",
        "[convolutional]", "filters=255", "size=1", "stride=1", "pad=1", "activation=linear", "",
        "[yolo]", "mask = 0,1,2", "anchors = 12, 16, 19, 36, 40, 28", "classes=80", "num=3",
        "scale_x_y = 1.2", ""]))
    spec = parse_darknet_cfg(str(path), 80)
    assert [layer.get("activation") for layer in spec.sub_models[0].layers[:2]] == [
        "mish", "linear"]
    assert spec.head_scales() == (1.2,)
    # the parsed model runs Mish: its head differs from the same weights run as leaky
    params, state = tnet.init_model(spec, torch.Generator().manual_seed(1))
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(2)) - 0.5
    with torch.no_grad():
        mish = tnet.apply_model(spec, params, state, x)[0]
        leaky = tnet.apply_model(_with_activation(spec, "mish", "leaky"), params, state, x)[0]
    assert not torch.equal(mish, leaky)
