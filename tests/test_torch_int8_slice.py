"""The port's int8 serving tiers end to end on the CPU against the JAX
package: ``apply_model`` on quantized params carried across, and
``make_predictor(quantize=...)`` with each side calibrating for itself, on
the synthetic spec of tests/test_torch_layers_network.py at 32 px and on
yolov3_tiny at 96 px with the in-repo trained checkpoint.

Tolerance. With JAX's quantized params carried across
(``qparams_from_jax``) every int8 tensor inside the network is equal and
every quantized layer's fp output bit-equal; the heads go through one fp
conv each and are held to 1e-5. End to end each library calibrates on its
own fp forward (absmax within 1e-4, tests/test_torch_quantize.py). On the
synthetic model the predictors still agree as the fp slice does: the same
detections (counts, selected indices, classes), boxes and scores 1e-4. On
trained tiny they cannot, and the test that holds them says why and to
what; the same pipeline on carried-across qparams is index-exact there."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.apps.inference_app import make_predictor as jax_make_predictor
from yolov3_tpu.io.resolve import load_weights as jax_load_weights
from yolov3_tpu.models import network as jnet
from yolov3_tpu.models.spec import parse_model_config as jax_parse
from yolov3_tpu.ops import quantize as jquant
from yolov3_tpu.ops import s2d as js2d
from yolov3_tpu_torch import config as tconfig
from yolov3_tpu_torch.apps.inference_app import (build_serving_predictor,
                                                 calibration_batches_from_dir, make_predictor)
from yolov3_tpu_torch.io.resolve import load_weights
from yolov3_tpu_torch.models import layers as TL
from yolov3_tpu_torch.models import network as tnet
from yolov3_tpu_torch.models.convert import params_from_jax, qparams_from_jax
from yolov3_tpu_torch.models.spec import parse_model_config
from yolov3_tpu_torch.ops.s2d import s2d_stem
from yolov3_tpu_torch.parallel import spatial

from .conftest import REPO
from .test_torch_layers_network import SYNTHETIC, _random_bn

SIZE = 32
ANCHORS = os.path.join(REPO, "datasets/shapes_toy/anchors/anchors_tiny.txt")
IMAGES = os.path.join(REPO, "datasets/shapes_toy/coco/images")


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    path = tmp_path_factory.mktemp("int8slice") / "model.yaml"
    path.write_text(SYNTHETIC)
    jspec, tspec = jax_parse(str(path), 2), parse_model_config(str(path), 2)
    jp, js = _random_bn(*jnet.init_model(jax.random.PRNGKey(3), jspec), 3)
    calib = [np.random.RandomState(0).rand(4, SIZE, SIZE, 3).astype(np.float32)]
    return jspec, tspec, jp, js, calib


def _observed(apply, *args):
    seen = {}

    def observe(sm_name, key, x):
        seen[(sm_name, key)] = np.asarray(x)

    return apply(*args, out_observer=observe), seen


@pytest.mark.parametrize("mode", ["int8", "int8_chain"])
def test_quantized_forward_matches_jax_with_qparams_carried_across(synthetic, mode):
    jspec, tspec, jp, js, calib = synthetic
    jf = jnet.fold_batch_norm(jp, js)
    in_absmax, out_absmax = jquant.calibrate_scales(jspec, jf, calib)
    jq = jquant.quantize_params(jspec, jf, in_absmax,
                                out_absmax=out_absmax if mode == "int8_chain" else None)
    tq = qparams_from_jax(jax.tree.map(np.asarray, jq))
    jspec, jq = js2d.s2d_stem(jspec, jq, image_size=SIZE)
    tspec, tq = s2d_stem(tspec, tq, image_size=SIZE)
    assert tspec.sub_models[0].layers[1]["size"] == 4  # the stem really is rewritten
    images = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)

    (jouts, _), jseen = _observed(jnet.apply_model, jspec, jq, {}, jnp.asarray(images))
    touts, tseen = _observed(tnet.apply_model, tspec, tq, {}, torch.from_numpy(images))
    assert len(touts) == len(jouts) == 2 and set(tseen) == set(jseen)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    quantized = [(sm, key) for sm in tq for key, e in tq[sm].items()
                 if "kernel_q" in e or set(e) == {"out_scale"}]
    assert len(quantized) == (8 if mode == "int8_chain" else 7)
    for tap in quantized:  # NCHW here, NHWC there
        np.testing.assert_array_equal(tseen[tap].transpose(0, 2, 3, 1), jseen[tap])
    if mode == "int8_chain":  # the chain really stays int8 between convs
        qact_inputs = []
        real = TL.conv2d_int8
        try:
            TL.conv2d_int8 = lambda x, *a, **k: (qact_inputs.append(isinstance(x, TL.QAct)),
                                                 real(x, *a, **k))[1]
            tnet.apply_model(tspec, tq, {}, torch.from_numpy(images))
        finally:
            TL.conv2d_int8 = real
        assert sum(qact_inputs) >= 4 and not qact_inputs[0]


def test_fused_stage_equals_the_interpreters_unfused_chain(synthetic):
    """K4's path on real layers: the synthetic backbone's residual block
    (layers 3-5) through ``fused_stage`` (here the kernel's plain version)
    on the int8 activation the chain-mode interpreter feeds it equals the
    interpreter's own output of the shortcut layer, bit for bit."""
    from yolov3_tpu_torch.models.spec import SubModelSpec
    from yolov3_tpu_torch.ops.cuda import resblock

    jspec, tspec, jp, js, calib = synthetic
    jf = jnet.fold_batch_norm(jp, js)
    in_absmax, out_absmax = jquant.calibrate_scales(jspec, jf, calib)
    tq = qparams_from_jax(jax.tree.map(np.asarray, jquant.quantize_params(
        jspec, jf, in_absmax, out_absmax=out_absmax)))
    tspec, tq = s2d_stem(tspec, tq, image_size=SIZE)
    sm = tspec.sub_models[0]
    assert resblock.residual_blocks(sm) == [[3]]
    cut = SubModelSpec(name=sm.name, layers=sm.layers[:6], inputs=sm.inputs,
                       outputs_layers=(2, 5), input_shape=sm.input_shape)
    images = torch.from_numpy(np.random.RandomState(4).rand(2, SIZE, SIZE, 3)
                              .astype(np.float32))
    x, want = (out.parts[0] for out in tnet._apply_sub_model(
        cut, tq[sm.name], {}, spatial.whole(images.permute(0, 3, 1, 2)), 2, torch.float32))
    assert isinstance(x, TL.QAct) and isinstance(want, TL.QAct)
    q, scale = resblock.fused_stage((x.q, x.scale), tq[sm.name], [3])
    assert float(scale) == float(want.scale) and len(torch.unique(q)) > 20
    np.testing.assert_array_equal(q.numpy(), want.q.numpy())


def test_routed_int8_chain_forward_equals_the_unrouted_one(synthetic, monkeypatch):
    """K4 in the int8_chain forward. The synthetic backbone's residual stage
    (C = 16, layers 3-5) is narrower than any tile pair the kernel is built
    for, so the port leaves it unfused; taken as supported it runs through
    ``resblock.fused_stage`` (on the CPU the kernel's plain version), and
    the heads are bit-equal to the unrouted forward's. A forward with an
    observer runs the stage unfused, so calibration sees every layer."""
    from yolov3_tpu_torch.ops.cuda import resblock

    jspec, tspec, jp, js, calib = synthetic
    jf = jnet.fold_batch_norm(jp, js)
    in_absmax, out_absmax = jquant.calibrate_scales(jspec, jf, calib)
    tq = qparams_from_jax(jax.tree.map(np.asarray, jquant.quantize_params(
        jspec, jf, in_absmax, out_absmax=out_absmax)))
    tspec, tq = s2d_stem(tspec, tq, image_size=SIZE)
    images = torch.from_numpy(np.random.RandomState(6).rand(2, SIZE, SIZE, 3)
                              .astype(np.float32))
    calls, real = [], resblock.fused_stage
    monkeypatch.setattr(resblock, "fused_stage",
                        lambda x, p, starts: (calls.append(starts), real(x, p, starts))[1])
    assert not resblock.supports(16, 8)
    assert tnet._fusable_stages(tspec.sub_models[0], tq["backbone"]) == {}
    unrouted = tnet.apply_model(tspec, tq, {}, images)
    assert calls == []
    monkeypatch.setattr(resblock, "supports", lambda c, cm: True)
    assert tnet._fusable_stages(tspec.sub_models[0], tq["backbone"]) == {3: [3]}
    routed = tnet.apply_model(tspec, tq, {}, images)
    assert calls == [[3]]
    assert len(routed) == len(unrouted) == 2
    for r, u in zip(routed, unrouted):
        assert torch.equal(r, u)
    observed = tnet.apply_model(tspec, tq, {}, images, out_observer=lambda *a: None)
    assert calls == [[3]]
    for o, u in zip(observed, unrouted):
        assert torch.equal(o, u)


def _compare_predictions(jax_out, torch_out):
    jb, jc, js_, jsel, jnv = map(np.asarray, jax_out)
    tb, tc, ts, tsel, tnv = (t.numpy() for t in torch_out)
    np.testing.assert_array_equal(tnv, jnv)
    np.testing.assert_array_equal(tsel, jsel)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js_, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4)
    return tnv


@pytest.mark.parametrize("mode", ["int8", "int8_chain"])
def test_int8_predictor_matches_jax_on_the_synthetic_model(synthetic, mode):
    jspec, tspec, jp, js, calib = synthetic
    tp, ts = params_from_jax(jp, js)
    anchors = tconfig.get_anchors(ANCHORS)
    args = (anchors, 2, 20, 0.5, 0.05)
    kwargs = dict(quantize=mode, calibration_batches=calib, image_size=SIZE)
    jpred = jax_make_predictor(jspec, jp, js, *args, **kwargs)
    tpred = make_predictor(tspec, tp, ts, *args, **kwargs, device="cpu")
    images = np.random.RandomState(2).rand(3, SIZE, SIZE, 3).astype(np.float32)
    nv = _compare_predictions(jpred(images), tpred(images))
    assert (nv > 0).all()


def _tiny():
    names = os.path.join(REPO, "datasets/shapes_toy/class.names")
    model = os.path.join(REPO, "config/models/yolov3_tiny/model.yaml")
    ckpt = os.path.join(REPO, "checkpoints/output/yolov3_train_tiny.tf")
    nc = len(tconfig.read_class_names(names))
    jspec, tspec = jax_parse(model, nc), parse_model_config(model, nc)
    jp, js = jax_load_weights(jspec, *jnet.init_model(jax.random.PRNGKey(0), jspec), ckpt)
    tp, ts = load_weights(tspec, *tnet.init_model(tspec, torch.Generator().manual_seed(0)),
                          ckpt)
    calib = calibration_batches_from_dir(IMAGES, 96, limit=4)
    assert calib[0].shape == (4, 96, 96, 3) and calib[0].dtype == np.float32
    return jspec, tspec, jp, js, tp, ts, calib, (tconfig.get_anchors(ANCHORS), nc, 100, 0.5, 0.1)


def test_int8_chain_pipeline_matches_jax_on_trained_tiny_with_qparams_carried_across():
    """yolov3_tiny (maxpools and an upsample on int8, no stem rewrite) with
    JAX's calibrated qparams carried across: forward + decode + NMS through
    ``make_predictor`` are index-exact, boxes and scores 1e-4."""
    jspec, tspec, jp, js, _, _, calib, args = _tiny()
    jf = jnet.fold_batch_norm(jp, js)
    in_absmax, out_absmax = jquant.calibrate_scales(jspec, jf, calib)
    jq = jquant.quantize_params(jspec, jf, in_absmax, out_absmax=out_absmax)
    tq = qparams_from_jax(jax.tree.map(np.asarray, jq))
    assert s2d_stem(tspec, tq, image_size=96) == (tspec, tq)
    jpred = jax_make_predictor(jspec, jq, {}, *args, fold_bn=False)
    tpred = make_predictor(tspec, tq, {}, *args, fold_bn=False, device="cpu")
    nv = _compare_predictions(jpred(calib[0][:2]), tpred(calib[0][:2]))
    assert (nv > 0).all()


def test_int8_chain_predictor_matches_jax_on_trained_tiny():
    """Each predictor calibrates for itself. The two fp forwards give absmax
    values 3.6e-7 apart (relative), which is enough to move 8 of the 13
    ``in_scale`` values by one ulp; a lattice value that flips on that is a
    step of absmax/127 in an activation, and the trained checkpoint's scores
    sit close together. Witness (image 1, 47 detections on both sides): JAX
    ranks candidates 82, 87 at scores 0.25821307, 0.2581233; the port ranks
    87, 82 at 0.25830495, 0.25815773 — the same boxes, 9e-5 apart in score
    and swapped in greedy order; the largest score difference over the two
    images is 2.3e-4. So this test holds what calibration leaves portable:
    the same number of detections per image, and scores (sorted) and the
    boxes of all candidates within 1e-3; the index-exact comparison of the
    same pipeline is the test above, on carried-across qparams."""
    jspec, tspec, jp, js, tp, ts, calib, args = _tiny()
    kwargs = dict(quantize="int8_chain", calibration_batches=calib, image_size=96)
    jpred = jax_make_predictor(jspec, jp, js, *args, **kwargs)
    tpred = make_predictor(tspec, tp, ts, *args, **kwargs, device="cpu")
    jb, _, jscore, jsel, jnv = map(np.asarray, jpred(calib[0][:2]))
    tb, _, tscore, tsel, tnv = (t.numpy() for t in tpred(calib[0][:2]))
    np.testing.assert_array_equal(tnv, jnv)
    assert (tnv > 0).all()
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-3)
    for i in range(2):
        np.testing.assert_allclose(np.sort(tscore[i][tsel[i][:tnv[i]]]),
                                   np.sort(jscore[i][jsel[i][:jnv[i]]]), rtol=0, atol=1e-3)


def test_build_serving_predictor_answers_in_int8_chain():
    """The detect-config entry point with ``quantize: int8_chain`` and a
    calibration directory (letterboxed, as a letterboxing server would ask)."""
    pred, names, model_name = build_serving_predictor(
        os.path.join(REPO, "config/models/yolov3_tiny/model.yaml"),
        os.path.join(REPO, "datasets/shapes_toy/class.names"), ANCHORS,
        os.path.join(REPO, "checkpoints/output/yolov3_train_tiny.tf"), 96,
        nms_score_threshold=0.1, quantize="int8_chain", calibration_images_dir=IMAGES,
        letterbox=True, device="cpu")
    images = calibration_batches_from_dir(IMAGES, 96, limit=2)[0]
    boxes, classes, scores, selected, num_valid = pred(images)
    assert model_name == "yolov3_tiny" and len(names) == 3
    assert tuple(selected.shape) == (2, 100) and (num_valid > 0).all()
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()


def test_int8_needs_calibration_and_folded_bn(synthetic):
    _, tspec, jp, js, calib = synthetic
    tp, ts = params_from_jax(jp, js)
    args = (tspec, tp, ts, tconfig.get_anchors(ANCHORS), 2, 20, 0.5, 0.05)
    with pytest.raises(ValueError, match="calibration_batches"):
        make_predictor(*args, quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="fold_bn"):
        make_predictor(*args, quantize="int8_chain", calibration_batches=calib,
                       fold_bn=False, device="cpu")
    with pytest.raises(ValueError, match="quantize must be"):
        make_predictor(*args, quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="calibration_images_dir"):
        build_serving_predictor(
            os.path.join(REPO, "config/models/yolov3_tiny/model.yaml"),
            os.path.join(REPO, "datasets/shapes_toy/class.names"), ANCHORS,
            os.path.join(REPO, "checkpoints/output/yolov3_train_tiny.tf"), 96,
            quantize="int8", device="cpu")
