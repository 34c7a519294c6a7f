"""The port's measurement tools on the CPU against the JAX package: the
per-layer profiler ranges of ``models/network.py``, ``tools/_measure.py``'s
derived inputs, and the pipelines of ``bench``, ``latency_bench``,
``profile_inference``, ``mfu_table``, ``profile_eval`` and
``bench_resblock`` (yolov3_tpu_torch/tools/), each held against the JAX
modules composed as the JAX tool composes them, on the same weights.

Weights: the in-repo trained YOLOv3-tiny (3 classes) loaded by both
packages; the int8 tiers on JAX's quantized params carried across
(``qparams_from_jax``, calibration is not bit-portable). The JAX tools cast
the images to bf16 for every tier; the port's int8 tiers run their fp parts
in float32 as its ``make_predictor`` builds them, so the int8 comparisons
feed float32 images to both, and the bf16 tier's pipeline is compared in
float32 (bf16 rounds elsewhere in the two libraries).

Tolerances: int8 / int8_chain selected indices and counts index-exact,
checksums 1e-5 relative; fp32 heads 1e-4, decode 1e-5 (the same heads into
both), NMS index-exact; the latency chain's accumulator 1e-4 relative; the
derived inputs bit-equal to numpy restatements of the JAX formulas; the MAC
tables equal entry by entry."""

import collections
import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.io.resolve import load_weights as jax_load_weights
from yolov3_tpu.models import layers as JL
from yolov3_tpu.models import network as jnet
from yolov3_tpu.models.spec import parse_model_config as jax_parse
from yolov3_tpu.ops import decode as jdecode
from yolov3_tpu.ops import detect as jdetect
from yolov3_tpu.ops import nms as jnms
from yolov3_tpu.ops import quantize as jquant
from yolov3_tpu.ops import s2d as js2d
from yolov3_tpu_torch.data.tfrecord import parse_tfrecords
from yolov3_tpu_torch.io.resolve import load_weights
from yolov3_tpu_torch.models import network as tnet
from yolov3_tpu_torch.models.convert import params_from_jax, qparams_from_jax
from yolov3_tpu_torch.models.spec import parse_model_config
from yolov3_tpu_torch.ops.decode import yolo_decode
from yolov3_tpu_torch.ops.s2d import s2d_stem
from yolov3_tpu_torch.tools import _measure as M
from yolov3_tpu_torch.utils import profiling as tprofiling
from yolov3_tpu_torch.tools import (bench, bench_resblock, latency_bench, mfu_table,
                                    profile_eval, profile_inference)

from .conftest import REPO
from .test_torch_layers_network import SYNTHETIC
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

TINY = os.path.join(REPO, "config/models/yolov3_tiny/model.yaml")
YOLOV3 = os.path.join(REPO, "config/models/yolov3/model.yaml")
CKPT = os.path.join(REPO, "checkpoints/output/yolov3_train_tiny.tf")
NAMES = os.path.join(REPO, "datasets/shapes_toy/class.names")
NC = 3
SIZE = 128


def _images(size, n=2):
    """The first ``n`` shapes_toy validation images at ``size``², float32."""
    it = parse_tfrecords(os.path.join(REPO, "datasets/shapes_toy/tfrecords/val"), size, 100,
                         NAMES)
    return np.stack([next(it)[0] for _ in range(n)]).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """The trained tiny in both packages: specs, JAX params/state, the port's,
    JAX's folded params and its int8 / int8_chain qparams (calibrated on two
    validation images) with the port's copies, and the anchors."""
    jspec, tspec = jax_parse(TINY, NC), parse_model_config(TINY, NC)
    jp, js = jax_load_weights(jspec, *jnet.init_model(jax.random.PRNGKey(0), jspec), CKPT)
    tp, ts = load_weights(tspec, *tnet.init_model(tspec, torch.Generator().manual_seed(0)),
                          CKPT)
    jf = jnet.fold_batch_norm(jp, js)
    in_absmax, out_absmax = jquant.calibrate_scales(jspec, jf, [_images(SIZE)])
    jq = {mode: jquant.quantize_params(jspec, jf, in_absmax,
                                       out_absmax=out_absmax if mode == "int8_chain" else None)
          for mode in ("int8", "int8_chain")}
    tq = {mode: qparams_from_jax(jax.tree.map(np.asarray, q)) for mode, q in jq.items()}
    tf = tnet.fold_batch_norm(tp, ts)
    return types.SimpleNamespace(jspec=jspec, tspec=tspec, jf=jf, tf=tf, jq=jq, tq=tq,
                                 anchors=M.seeded_anchors(2))


def _tier(tiny, tier):
    """(JAX params, port params) of a tier: fp32 folded, or the carried int8."""
    if tier == "fp32":
        return tiny.jf, tiny.tf
    return tiny.jq[tier], tiny.tq[tier]


# -- layer ranges (models/network.py) -----------------------------------------

def _range_names(prof):
    return [e.name for e in prof.events() if e.name.startswith("L|")]


def test_layer_ranges_are_the_jax_named_scopes(tiny):
    """One range per layer under torch.profiler, named as the JAX package's
    ``named_scope`` (``yolov3_tpu/models/network.py:93``)."""
    x = torch.from_numpy(_images(64, 1))
    with torch.profiler.profile() as prof:
        tnet.apply_model(tiny.tspec, tiny.tf, {}, x)
    names = _range_names(prof)
    want = [f"L|{sm.name}|layer{i}|{layer.kind}" for sm in tiny.jspec.sub_models
            for i, layer in enumerate(sm.layers)]
    assert len(names) == len(want) == len(set(names))
    assert set(names) == set(want)


def test_fused_stage_is_one_range_over_its_layers(tmp_path):
    """``int8_chain`` on a spec with a residual stage: the stage runs fused
    under one range ``L|<sm>|layer<a>-layer<b>|resblock`` and its layers have
    none of their own."""
    wide = SYNTHETIC  # the residual block widened to a shape K4 takes (C 64, Cm 32)
    for a, b in (("filters: 16, size: 3, stride: 2", "filters: 64, size: 3, stride: 2"),
                 ("filters: 8, size: 1", "filters: 32, size: 1"),
                 ("filters: 16, size: 3, stride: 1", "filters: 64, size: 3, stride: 1")):
        wide = wide.replace(a, b, 1)
    path = tmp_path / "model.yaml"
    path.write_text(wide)
    jspec, tspec = jax_parse(str(path), 2), parse_model_config(str(path), 2)
    jp, js = jnet.init_model(jax.random.PRNGKey(3), jspec)
    jf = jnet.fold_batch_norm(jp, js)
    calib = [np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)]
    in_absmax, out_absmax = jquant.calibrate_scales(jspec, jf, calib)
    tq = qparams_from_jax(jax.tree.map(np.asarray, jquant.quantize_params(
        jspec, jf, in_absmax, out_absmax=out_absmax)))
    tspec, tq = s2d_stem(tspec, tq, image_size=32)
    with torch.profiler.profile() as prof:
        tnet.apply_model(tspec, tq, {}, torch.from_numpy(calib[0]))
    names = _range_names(prof)
    sm = tspec.sub_models[0].name
    assert f"L|{sm}|layer3-layer5|resblock" in names
    assert not any(n.startswith(f"L|{sm}|layer{i}|") for n in names for i in (3, 4, 5))
    assert mfu_table.range_layers(f"L|{sm}|layer3-layer5|resblock") == (
        sm, "layer3-layer5", ["layer3", "layer4", "layer5"])


def test_no_range_entered_without_a_profiler_and_outputs_unchanged(tiny, monkeypatch):
    # the layer ranges are the profiler half of the port's spans
    # (utils/profiling.py::profiler_range), which enters record_function
    entered = []
    real = tprofiling.record_function
    monkeypatch.setattr(tprofiling, "record_function",
                        lambda name: (entered.append(name), real(name))[1])
    x = torch.from_numpy(_images(64, 1))
    plain = tnet.apply_model(tiny.tspec, tiny.tf, {}, x)
    assert entered == []
    with torch.profiler.profile():
        profiled = tnet.apply_model(tiny.tspec, tiny.tf, {}, x)
    assert len(entered) == sum(len(sm.layers) for sm in tiny.tspec.sub_models)
    for a, b in zip(plain, profiled):
        assert torch.equal(a, b)


def test_export_graph_unchanged_by_the_ranges(tiny, monkeypatch):
    """``torch.export`` of the serving ``Detector`` holds the same nodes with
    the ranges as with them patched out."""
    from yolov3_tpu_torch.apps.inference_app import Detector
    from yolov3_tpu_torch.export.aot import export_detector

    def graph():
        det = Detector(tiny.tspec, tiny.tf, {}, torch.from_numpy(tiny.anchors), NC, 100, 0.5,
                       0.25)
        nodes = export_detector(det, 64, platforms=("cpu",))["cpu"].graph.nodes
        return [(n.op, str(n.target)) for n in nodes]

    with_ranges = graph()
    monkeypatch.setattr(tnet, "_layer_range", lambda name: tprofiling.NO_RANGE)
    assert graph() == with_ranges
    assert not any("record_function" in t or "profiler" in t for _, t in with_ranges)


# -- the derived inputs (tools/_measure.py) ------------------------------------

def test_derived_inputs_are_the_jax_formulas():
    base = M.staged_uint8(2, 8, "cpu")
    np.testing.assert_array_equal(
        base.numpy(), np.random.RandomState(0).randint(0, 256, (2, 8, 8, 3)).astype(np.uint8))
    for i in (0, 1, 7, 255, 256, 300):
        want = (base.numpy() + np.uint8(i % 256)).astype(np.float32) * np.float32(1.0 / 255.0)
        got = M.derived_images(base, i).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        jax_got = np.asarray((jnp.asarray(base.numpy()) + jnp.int32(i).astype(jnp.uint8))
                             .astype(jnp.float32) * (1.0 / 255.0))
        np.testing.assert_array_equal(got.view(np.uint32), jax_got.view(np.uint32))
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 8, 8, 3).astype(np.float32))
    for i, xi in enumerate(profile_inference.perturbed_inputs(x, 4)):
        want = x.numpy() * (np.float32(1.0) + np.float32(1e-4) * np.float32(i))
        np.testing.assert_array_equal(xi.numpy().view(np.uint32), want.view(np.uint32))
        jax_want = np.asarray(jax.jit(lambda a, j: a * (1.0 + 1e-4 * j))(
            jnp.asarray(x.numpy()), jnp.float32(i)))
        np.testing.assert_array_equal(xi.numpy().view(np.uint32), jax_want.view(np.uint32))


def test_latency_chain_update_is_the_jax_formula():
    img = torch.from_numpy(np.random.RandomState(2).rand(1, 8, 8, 3).astype(np.float32))
    for s in (0.0, 3.25, 117.8125, -41.5):
        got = latency_bench.chained(lambda _: torch.tensor(np.float32(s)), img, 2)
        once = img * (1.0 + 1e-6 * torch.tanh(torch.tensor(np.float32(s))))
        want = img.numpy() * (np.float32(1.0) + np.float32(1e-6) * np.tanh(np.float32(s)))
        np.testing.assert_array_equal(once.numpy().view(np.uint32), want.view(np.uint32))
        assert float(got) == np.float32(2 * np.float32(s))


# -- the pipelines, against the JAX tools' compositions ------------------------

def _jax_bench(jspec, jp, anchors, images, path):
    """``bench.py:112-128``: forward → decode → yolo_nms (K=256) → gather, or
    detect; the checksum."""
    outs, _ = jnet.apply_model(jspec, jp, {}, jnp.asarray(images), train=False)
    if path == "fused":
        det = jdetect.detect(outs, anchors, NC, max_boxes=100, iou_threshold=0.5,
                             score_threshold=0.25, num_candidates=256)
        nms = None
    else:
        boxes, conf, probs = jdecode.yolo_decode(outs, anchors, NC)
        nms = jnms.yolo_nms(boxes, conf, probs, max_boxes=100, iou_threshold=0.5,
                            score_threshold=0.25, num_candidates=256)
        det = jnms.gather_detections(*nms)
    db, _, ds, valid = det
    return det, nms, float(jnp.sum(db) + jnp.sum(ds) + jnp.sum(valid)), outs


def _assert_selection_equal(tnms, jnms_out):
    tsel, tnv = tnms[3].numpy(), tnms[4].numpy()
    jsel, jnv = np.asarray(jnms_out[3]), np.asarray(jnms_out[4])
    np.testing.assert_array_equal(tnv, jnv)
    for i in range(len(tnv)):
        np.testing.assert_array_equal(tsel[i, :tnv[i]], jsel[i, :jnv[i]])
    return tnv


@pytest.mark.parametrize("tier", ["int8", "int8_chain", "fp32"])
def test_bench_pipeline_matches_jax(tiny, tier):
    jp, tp = _tier(tiny, tier)
    images = _images(SIZE)
    (tdet, tnms) = bench.pipeline(tiny.tspec, tp, torch.from_numpy(tiny.anchors), NC,
                                  torch.from_numpy(images))
    jdet, jnms_out, jsum, jouts = _jax_bench(tiny.jspec, jp, tiny.anchors, images, "classic")
    nv = _assert_selection_equal(tnms, jnms_out)
    assert nv.sum() > 0
    tsum = float(M.detections_checksum(tdet[0], tdet[2], tdet[3]))
    np.testing.assert_allclose(tsum, jsum, rtol=1e-5)
    np.testing.assert_array_equal(tdet[1].numpy(), np.asarray(jdet[1]))
    if tier == "fp32":
        touts = tnet.apply_model(tiny.tspec, tp, {}, torch.from_numpy(images))
        for t, j in zip(touts, jouts):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-4)
        heads = [np.array(j) for j in jouts]
        tdec = yolo_decode([torch.from_numpy(h) for h in heads], torch.from_numpy(tiny.anchors),
                           NC)
        jdec = jdecode.yolo_decode([jnp.asarray(h) for h in heads], tiny.anchors, NC)
        for t, j in zip(tdec, jdec):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_bench_fused_path_matches_jax(tiny):
    images = _images(SIZE)
    (tb, tc, ts, tv), _ = bench.pipeline(tiny.tspec, tiny.tq["int8_chain"],
                                         torch.from_numpy(tiny.anchors), NC,
                                         torch.from_numpy(images), path="fused")
    (jb, jc, js, jv), _, jsum, _ = _jax_bench(tiny.jspec, tiny.jq["int8_chain"], tiny.anchors,
                                              images, "fused")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().sum() > 0
    np.testing.assert_array_equal(tc.numpy()[tv.numpy()], np.asarray(jc)[np.asarray(jv)])
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(M.detections_checksum(tb, ts, tv)), jsum, rtol=1e-5)


@pytest.mark.parametrize("tier", ["int8_chain", "fp32"])
def test_latency_chain_matches_jax(tiny, tier):
    """Two chained B=1 predicts (``latency_bench.py:64-79``): the accumulator
    1e-4 relative."""
    jp, tp = _tier(tiny, tier)
    x = np.random.RandomState(0).rand(1, SIZE, SIZE, 3).astype(np.float32)
    x[0] = _images(SIZE, 1)[0]  # a real image: the predicts detect something
    anchors = torch.from_numpy(tiny.anchors)
    got = latency_bench.chained(
        lambda img: latency_bench.one_predict(tiny.tspec, tp, anchors, NC, img, 128),
        torch.from_numpy(x), 2)
    img, acc = jnp.asarray(x), jnp.float32(0.0)
    for _ in range(2):
        outs, _ = jnet.apply_model(tiny.jspec, jp, {}, img, train=False)
        b, _, s, v = jdetect.detect(outs, tiny.anchors, NC, max_boxes=100, iou_threshold=0.5,
                                    score_threshold=0.25, num_candidates=128)
        sc = jnp.sum(b) + jnp.sum(s) + jnp.sum(v)
        img = img * (1.0 + 1e-6 * jnp.tanh(sc))
        acc = acc + sc
    assert float(acc) > 1.0
    np.testing.assert_allclose(float(got), float(acc), rtol=1e-4)


def test_profile_inference_stages_match_jax(tiny):
    """The four stages (``profile_inference.py:43-58``) in float32."""
    images = _images(SIZE)
    outs, _ = jnet.apply_model(tiny.jspec, tiny.jf, {}, jnp.asarray(images), train=False)
    boxes, conf, probs = jdecode.yolo_decode(outs, tiny.anchors, NC)
    nms = jnms.yolo_nms(boxes, conf, probs, max_boxes=100, iou_threshold=0.5,
                        score_threshold=0.25, num_candidates=256)
    db, _, ds, v = jnms.gather_detections(*nms)
    fb, _, fs, fv = jdetect.detect(outs, tiny.anchors, NC, num_candidates=256)
    want = {"forward": sum(jnp.sum(o) for o in outs),
            "+decode": jnp.sum(boxes) + jnp.sum(conf) + jnp.sum(probs),
            "+nms (full pipeline)": jnp.sum(db) + jnp.sum(ds) + jnp.sum(v),
            "fused-detect": jnp.sum(fb) + jnp.sum(fs) + jnp.sum(fv)}
    assert set(want) == set(profile_inference.STAGES)
    for stage in profile_inference.STAGES:
        got = profile_inference.stage_checksum(stage, tiny.tspec, tiny.tf,
                                               torch.from_numpy(tiny.anchors), NC,
                                               torch.from_numpy(images), 256)
        np.testing.assert_allclose(float(got), float(want[stage]), rtol=1e-5, err_msg=stage)


@pytest.mark.parametrize("tier,k", [("fp32", 512), ("fp32", None), ("int8", None)])
def test_profile_eval_sweep_matches_jax(tiny, tier, k):
    """The sweep (``profile_eval.py:72-92``) at 224² (N = 735 candidates): at
    K = N the port takes the round sweep (K2's plain version), at K=512 the
    matrix (K1's); the selected indices and counts of every threshold are
    integers, so the checksums are equal."""
    jp, tp = _tier(tiny, tier)
    images = _images(224)
    n = 3 * (7 * 7 + 14 * 14)
    k = n if k is None else k
    thresholds = [0.004, 0.1, 0.2, 0.5, 0.9]
    got = profile_eval.sweep_checksum(tiny.tspec, tp, torch.from_numpy(tiny.anchors), NC,
                                      torch.from_numpy(images), thresholds, k)
    outs, _ = jnet.apply_model(tiny.jspec, jp, {}, jnp.asarray(images), train=False)
    boxes, conf, probs = jdecode.yolo_decode(outs, tiny.anchors, NC)
    assert boxes.shape[1] == n
    want = 0.0
    for thr in thresholds:
        out = jnms.yolo_nms(boxes, conf, probs, max_boxes=100, iou_threshold=0.5,
                            score_threshold=thr, num_candidates=k)
        want += float(jnp.sum(out[3].astype(jnp.float32)) + jnp.sum(out[4].astype(jnp.float32)))
    assert want > 0
    assert float(got) == want


# -- mfu_table ------------------------------------------------------------------

def _jax_mfu_tool():
    spec = importlib.util.spec_from_file_location("jax_tools_mfu_table",
                                                  os.path.join(REPO, "tools/mfu_table.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layouts(model, layout, size):
    """(JAX spec, JAX params, port spec, port params) of ``model`` in the bf16
    layout (folded, HWIO / OIHW kernels) or the ``int8_chain`` layout
    (``kernel_q``, space-to-depth stem) with every absmax 1."""
    jspec, tspec = jax_parse(model, 80), parse_model_config(model, 80)
    jp, js = jnet.init_model(jax.random.PRNGKey(0), jspec)
    jf = jax.tree.map(np.asarray, jnet.fold_batch_norm(jp, js))
    if layout == "bf16":
        return jspec, jf, tspec, params_from_jax(jf, {})[0]
    layers = {(sm.name, f"layer{i}"): layer.kind for sm in jspec.sub_models
              for i, layer in enumerate(sm.layers)}
    taps = dict.fromkeys(layers, 1.0)
    convs = {k: 1.0 for k, kind in layers.items() if kind == "convolutional"}
    jq = jquant.quantize_params(jspec, jf, convs, out_absmax=taps)
    tq = qparams_from_jax(jax.tree.map(np.asarray, jq))
    jspec, jq = js2d.s2d_stem(jspec, jq, image_size=size)
    tspec, tq = s2d_stem(tspec, tq, image_size=size)
    return jspec, jq, tspec, tq


@pytest.mark.parametrize("name,layout", [("yolov3", "bf16"), ("yolov3", "int8_chain"),
                                         ("yolov3_tiny", "bf16"), ("yolov3_tiny", "int8_chain")])
def test_mfu_macs_equal_the_jax_tool(name, layout):
    model = {"yolov3": YOLOV3, "yolov3_tiny": TINY}[name]
    size, batch = 96, 3
    jspec, jparams, tspec, tparams = _layouts(model, layout, size)
    want = _jax_mfu_tool().layer_shapes_and_macs(jspec, jparams, batch, size)
    got = mfu_table.layer_shapes_and_macs(tspec, tparams, batch, size)
    assert got == want
    assert sum(e["macs"] for e in got.values()) > 0
    if layout == "int8_chain" and model == YOLOV3:
        assert got[("backbone", "layer1")]["desc"].startswith("4x4 3->")  # the s2d stem


def _event(name, parent=None, kernels=()):
    Kernel = collections.namedtuple("Kernel", "name device duration")
    return types.SimpleNamespace(name=name, cpu_parent=parent,
                                 kernels=[Kernel(n, 0, d) for n, d in kernels])


def test_mfu_attribution_of_a_synthetic_trace():
    """Nested ranges (the innermost wins), a fused-stage range, kernels with
    no range; the profile window's pads and a range's own device span left
    out."""
    outer = _event("L|backbone|layer0|convolutional")
    inner = _event("L|backbone|layer1|convolutional", outer)
    conv = _event("aten::cudnn_convolution", inner, [("sm90_xmma", 30.0), ("fill", 2.0)])
    stem = _event("aten::add", outer, [("elementwise", 5.0)])
    stage = _event("L|backbone|layer3-layer8|resblock")
    k4 = _event("yolov3_torch::fused_resblock", stage, [("resblock_int8", 40.0)])
    k4b = _event("yolov3_torch::fused_resblock", stage, [("resblock_int8", 41.0)])
    cast = _event("aten::to", None, [("copy_kernel", 7.0)])
    pad = _event("aten::something", None, [("spin_kernel", 10000.0)])
    span = _event("L|backbone|layer2|convolutional", outer,
                  [("L|backbone|layer2|convolutional", 3000.0)])  # its device span
    per_range, unattributed = mfu_table.attribute(
        [outer, inner, conv, stem, stage, k4, k4b, cast, pad, span])
    assert per_range == {"L|backbone|layer1|convolutional": 32.0,
                         "L|backbone|layer0|convolutional": 5.0,
                         "L|backbone|layer3-layer8|resblock": 81.0}
    assert unattributed == {"copy_kernel": 7.0}
    macs = {("backbone", f"layer{i}"): {"macs": 1000 * (i + 1), "desc": f"c{i}", "kind": "c"}
            for i in range(9)}
    rows = mfu_table.table_rows(per_range, macs, steps=1, peak=1e12)
    stage_row = next(r for r in rows if r["layer"] == "backbone/layer3-layer8")
    assert stage_row["gflops"] == 2 * sum(1000 * (i + 1) for i in range(3, 9)) / 1e9
    assert stage_row["desc"] == "K4 stage, 2 blocks"
    assert [r["layer"] for r in rows][0] == "backbone/layer3-layer8"


def test_range_spans_are_not_device_records():
    """A range's span on the device's timeline (a user annotation, or named
    as the layer ranges) is left out of ``profile_window``'s records."""
    from yolov3_tpu_torch.ops.cuda.kernel_times import is_range_span

    assert is_range_span(types.SimpleNamespace(name="L|backbone|layer1|convolutional"))
    assert is_range_span(types.SimpleNamespace(name="Optimizer.step", is_user_annotation=True))
    assert not is_range_span(types.SimpleNamespace(name="conv_int8_wgmma",
                                                   is_user_annotation=False))
    assert not is_range_span(types.SimpleNamespace(name="sm90_xmma_fprop"))


# -- bench_resblock ------------------------------------------------------------

def test_bench_resblock_paths_agree_with_each_other_and_jax():
    """One block of each path at 13² (C=1024) on the seeded inputs: the
    unfused chain bit-equal to the JAX tool's ``xla_block``
    (``bench_resblock.py:64-67``), the fused block (K4's plain version) to
    the unfused chain after three chained blocks."""
    from yolov3_tpu_torch.ops.cuda import resblock

    xq, squeeze, expand, shortcut, s_x = bench_resblock.block_inputs(1, 13, "cpu")
    got = bench_resblock.unfused_block(xq, squeeze, expand, shortcut, s_x)

    def jax_entry(e):
        return {"kernel_q": jnp.asarray(e["kernel_q"].numpy().transpose(1, 2, 3, 0)),
                "w_scale": jnp.asarray(e["w_scale"].numpy()),
                "bias": jnp.asarray(e["bias"].numpy()),
                "out_scale": jnp.float32(e["out_scale"].numpy())}

    x = JL.QAct(jnp.asarray(xq.numpy()), jnp.float32(s_x.numpy()))
    a = JL.conv2d_int8(x, jax_entry(squeeze), stride=1, pad=1, leaky=True)
    a = JL.conv2d_int8(a, jax_entry(expand), stride=1, pad=1, leaky=True)
    want = JL.add_requant(x, a, jnp.float32(shortcut["out_scale"].numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.q))
    paths = bench_resblock.chains(1, 13, 3, torch.device("cpu"))
    np.testing.assert_array_equal(resblock.from_halo(paths["fused"](), 1, 13, 13).numpy(),
                                  paths["unfused"]().numpy())


# -- main(argv) of each tool on the CPU ----------------------------------------

def test_bench_main_on_the_cpu(capsys):
    env = dict(BENCH_BATCH="2", BENCH_IMAGE_SIZE="64", BENCH_ITERS="2",
               BENCH_QUANTIZE="int8_chain", BENCH_MODEL="yolov3_tiny")
    out = bench.main(["--device", "cpu"], env=env)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert line["metric"] == "yolov3_tiny_64_batch_inference_images_per_sec_per_chip"
    assert line["device"] == "cpu" and line["unit"] == "images/sec"
    assert line["vs_baseline"] == round(line["value"] / 2000.0, 4)
    assert np.isfinite(out["checksum"])
    with pytest.raises(ValueError, match="BENCH_QUANTIZE"):
        bench.knobs({"BENCH_QUANTIZE": "fp8"})


def test_latency_profile_inference_eval_mfu_resblock_mains_on_the_cpu(capsys):
    tiny = ["--model_config_file", "config/models/yolov3_tiny/model.yaml"]
    r = latency_bench.main(tiny + ["--image_size", "64", "--iters", "2", "--reps", "3",
                                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("p50 host-clock time per B=1 predict (bf16, 64x64, K=128): ")
    assert "device-busy per predict: not measured; device: cpu" in out
    assert r["device_busy_us"] is None and len(r["host_ms"]) == 3

    r = profile_inference.main(tiny + ["--batch", "2", "--image_size", "64", "--iters", "2",
                                       "--passes", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu, batch 2 @ 64"
    assert [ln.split(":")[0].strip() for ln in lines[1:]] == list(profile_inference.STAGES)
    assert all("ms/batch" in ln and ln.endswith("img/s") for ln in lines[1:])

    profile_eval.main(["--batch", "1", "--image_size", "32", "--iters", "1",
                       "--thresholds", "0.004,0.5", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["eval_sweep"] for ln in lines] == ["K=512", "K=N(63)"]
    assert all(ln["device"] == "cpu" and ln["thresholds"] == [0.004, 0.5] for ln in lines)

    r = mfu_table.main(["--model", "yolov3_tiny", "--batch", "1", "--image_size", "64",
                        "--quantize", "int8_chain", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["device_ms_fwd"] is None
    assert line["model_flops_g"] > 0 and line["e2e_mfu_pct"] is None

    bench_resblock.main(["--b", "1", "--iters", "1", "--stages", "13", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("13x13 c=1024: unfused ") and "fused" in lines[1]
    assert json.loads(lines[-1])["device"] == "cpu"


def test_tools_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for tool, argv in ((latency_bench, []), (profile_inference, []), (profile_eval, []),
                       (mfu_table, []), (bench_resblock, [])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([], env={})
