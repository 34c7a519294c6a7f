"""The port's serving artifact (``export/aot.py``, ``apps/export_app.py``,
``cli export``, the serve command's ``artifact:`` key) and the
``torch.library`` ops of the kernels on its path, on the CPU.

Each tier's predictor (fp32 and int8 on the trained YOLOv3-tiny, and
``int8_chain`` on a small Darknet-stem model with one residual stage that
K4 takes) is exported over a symbolic batch, saved, loaded and run against
the eager predictor it came from: bit-equal at B = 1, 3 and 5 (the same
operations on the same inputs). Against the JAX package's own artifact on
the same weights (``yolov3_tpu.export.aot``): fp32 NMS index-exact, boxes and
scores within 1e-5 (two frameworks' float32 convolutions); int8 with JAX's
quantized params carried across (calibration is not bit-portable,
tests/test_torch_int8_slice.py), index-exact and within 1e-5 too. Both on
shapes_toy images the int8 tier was not calibrated on (measured: scores
3e-8 apart). On uniform noise, far from what was calibrated, the two
packages' int8 scores came 1.5e-4 apart (a quantized activation rounded to
another lattice point) and greedy NMS swapped near-tied boxes.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import urllib.request
import zipfile

import jax
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.apps.export_app import export_artifact as jax_export_artifact
from yolov3_tpu.apps.inference_app import make_predictor as jax_make_predictor
from yolov3_tpu.export import aot as jaot
from yolov3_tpu.io.resolve import load_weights as jax_load_weights
from yolov3_tpu.models import fold_batch_norm as jax_fold
from yolov3_tpu.models import init_model as jax_init
from yolov3_tpu.models import parse_model_config as jax_parse
from yolov3_tpu.ops import quantize as jquant
from yolov3_tpu_torch.apps import cli
from yolov3_tpu_torch.apps.inference_app import (build_serving_predictor,
                                                 calibration_batches_from_dir, make_predictor)
from yolov3_tpu_torch.apps.serve_app import Serve
from yolov3_tpu_torch.config import get_anchors
from yolov3_tpu_torch.export import aot
from yolov3_tpu_torch.models import init_model, parse_model_config
from yolov3_tpu_torch.models.convert import qparams_from_jax
from yolov3_tpu_torch.ops.cuda import conv1x1, conv_int8, nms_kernel, resblock, round_sweep

from .conftest import REPO
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

SIZE = 96
NAMES = os.path.join(REPO, "datasets/shapes_toy/class.names")
ANCHORS = os.path.join(REPO, "datasets/shapes_toy/anchors/anchors_tiny.txt")
IMAGES = os.path.join(REPO, "datasets/shapes_toy/coco/images")
TINY = os.path.join(REPO, "config/models/yolov3_tiny/model.yaml")
TRAINED_TINY = os.path.join(REPO, "checkpoints/output/yolov3_train_tiny.tf")
# the trained tiny's scores top out near 0.26
SCORE_THR = 0.05
# MINI of tests/test_torch_train_extras.py (Darknet stem, stride-2 convs to
# /32, two heads) with one residual block at /32, C = 64 squeezed to 32: a
# stage the fused residual-block kernel (K4) takes
MINI_RES = """
output_stage: head
sub_models_configs:
- name: backbone
  layers_config:
  - {type: route, source: {inputs: [0]}}
  - {type: convolutional, filters: 8, size: 3, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: 16, size: 3, stride: 2, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: 16, size: 3, stride: 2, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: 32, size: 3, stride: 2, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: 32, size: 3, stride: 2, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: 64, size: 3, stride: 2, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: 32, size: 1, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: 64, size: 3, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: shortcut, from: -3, activation: linear}
  outputs_layers: [5, -1]
- name: head0
  inputs:
    source:
    - {name: backbone, entry_index: 1}
  layers_config:
  - {type: route, source: {inputs: [0]}}
  - {type: convolutional, filters: 32, size: 1, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: 64, size: 3, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: '3*(5+nclasses)', size: 1, stride: 1, pad: 1, activation: linear}
  - {type: yolo}
  outputs_layers: [-1]
- name: head1
  inputs:
    source:
    - {name: backbone, entry_index: 1}
    - {name: backbone, entry_index: 0}
  layers_config:
  - {type: route, source: {inputs: [0]}}
  - {type: convolutional, filters: 16, size: 1, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: upsample, stride: 2}
  - {type: route, source: {layers: [-1], inputs: [1]}}
  - {type: convolutional, filters: 32, size: 3, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: '3*(5+nclasses)', size: 1, stride: 1, pad: 1, activation: linear}
  - {type: yolo}
  outputs_layers: [-1]
"""
# the ops each tier's exported program must hold as nodes
OPS = {"fp32": {"suppression_sweep"},
       "int8": {"suppression_sweep", "conv1x1_int8_requant", "conv_int8"},
       "int8_chain": {"suppression_sweep", "conv1x1_int8_requant", "conv_int8",
                      "fused_resblock"}}


def _images(seed, b):
    return np.random.RandomState(seed).rand(b, SIZE, SIZE, 3).astype(np.float32)


def _toy_images():
    """Three shapes_toy images, square-resized, past the four the int8 tiers
    calibrate on."""
    return calibration_batches_from_dir(IMAGES, SIZE, 7)[0][4:]


def _detect_config(**overrides):
    cfg = dict(model_config_file=TINY, classes_name_file=NAMES, anchors_file=ANCHORS,
               input_weights_path=TRAINED_TINY, image_size=SIZE, yolo_max_boxes=100,
               nms_iou_threshold=0.5, nms_score_threshold=SCORE_THR)
    cfg.update(overrides)
    return cfg


def _mini_res_predictor(path):
    spec = parse_model_config(path, 3)
    params, state = init_model(spec, torch.Generator().manual_seed(5))
    return make_predictor(spec, params, state, get_anchors(ANCHORS), 3, 100, 0.5, SCORE_THR,
                          quantize="int8_chain",
                          calibration_batches=calibration_batches_from_dir(IMAGES, SIZE, 4),
                          image_size=SIZE, device="cpu")


def _op_names(program):
    return {str(n.target).split(".")[1] for n in program.graph_module.graph.nodes
            if str(n.target).startswith("yolov3_torch.")}


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("export")


@pytest.fixture(scope="module")
def mini_res_file(workdir):
    path = workdir / "mini_res.yaml"
    path.write_text(MINI_RES)
    return str(path)


@pytest.fixture(scope="module")
def exported(workdir, mini_res_file):
    """tier → (the eager predictor, the artifact's path, the op names of its
    program). Each predictor is exported before it answers anything (a cold
    export)."""
    out = {}
    for tier in OPS:
        if tier == "int8_chain":
            predictor = _mini_res_predictor(mini_res_file)
        else:
            predictor, _, _ = build_serving_predictor(
                **_detect_config(), quantize=tier if tier == "int8" else None,
                calibration_images_dir=IMAGES, device="cpu")
        programs = aot.export_detector(predictor.module, SIZE, ("cpu",))
        path = str(workdir / f"{tier}.zip")
        aot.save_detector_artifact(path, programs, {"image_size": SIZE, "quantize": tier})
        out[tier] = predictor, path, _op_names(programs["cpu"])
    return out


@pytest.mark.parametrize("tier", list(OPS))
def test_artifact_equals_the_eager_predictor(exported, tier):
    """Loaded on the CPU, the program answers B = 1, 3 and 5 (one program,
    a symbolic batch) bit-equal to the predictor it was exported from, and
    holds each kernel of its tier as an op node."""
    predictor, path, ops = exported[tier]
    assert ops == OPS[tier]
    loaded, manifest = aot.load_detector_artifact(path, device="cpu")
    assert manifest["platforms"] == ["cpu"] and manifest["quantize"] == tier
    assert loaded.device == torch.device("cpu")
    for b in (1, 3, 5):
        images = _images(b, b)
        want, got = predictor(images), loaded(torch.from_numpy(images))
        assert _equal(got, want), (tier, b)
        assert int(want[4].sum()) > 0
        assert tuple(got[3].shape) == (b, 100) and got[3].dtype == torch.int32


def test_cold_export_leaves_the_eager_int8_chain_predictor_unchanged(exported, mini_res_file):
    """The exported ``int8_chain`` predictor (its first call came after the
    export) answers bit-equal to a fresh one: nothing a trace made stays in
    it. Its residual block runs through K4's op with the constants packed
    when the predictor was built."""
    predictor, _, _ = exported["int8_chain"]
    fresh = _mini_res_predictor(mini_res_file)
    squeeze = predictor.module.tree("params")["backbone"]["layer7"]
    assert set(squeeze["fused"]) == {"w1", "w2", "bias1", "inv_s1", "scale2", "bias2",
                                     "inv_s2", "s2", "inv_out"}
    for b in (1, 3):
        images = _images(10 + b, b)
        assert _equal(predictor(images), fresh(images))


@pytest.fixture(scope="module")
def jax_artifact(workdir):
    """The JAX package's artifact of the fp32 trained tiny, written by its
    export application from the same config."""
    path = str(workdir / "jax_fp32.yoloexp")
    with contextlib.redirect_stdout(io.StringIO()):
        manifest = jax_export_artifact(_detect_config(), path, platforms=("cpu",))
    return path, manifest


def _assert_same_detections(got, want):
    gb, gc, gs, gsel, gnv = (t.numpy() for t in got)
    wb, wc, ws, wsel, wnv = map(np.asarray, want)
    np.testing.assert_array_equal(gnv, wnv)
    np.testing.assert_array_equal(gsel, wsel)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    assert (gnv > 0).all()


def test_fp32_artifact_matches_the_jax_artifact(exported, jax_artifact):
    jpredict, _ = jaot.load_detector_artifact(jax_artifact[0])
    predict, _ = aot.load_detector_artifact(exported["fp32"][1], device="cpu")
    images = _toy_images()
    _assert_same_detections(predict(images), jpredict(images))


def test_int8_artifact_matches_the_jax_artifact_with_qparams_carried_across(workdir):
    nc = 3
    jspec, tspec = jax_parse(TINY, nc), parse_model_config(TINY, nc)
    jp, js = jax_load_weights(jspec, *jax_init(jax.random.PRNGKey(0), jspec), TRAINED_TINY)
    jf = jax_fold(jp, js)
    in_absmax, _ = jquant.calibrate_scales(jspec, jf, calibration_batches_from_dir(IMAGES, SIZE,
                                                                                  4))
    jq = jquant.quantize_params(jspec, jf, in_absmax)
    args = (get_anchors(ANCHORS), nc, 100, 0.5, SCORE_THR)
    jpredictor = jax_make_predictor(jspec, jq, {}, *args, fold_bn=False)
    jpath = str(workdir / "jax_int8.yoloexp")
    jaot.save_detector_artifact(jpath, jaot.export_detector(jpredictor, SIZE, ("cpu",)), {})
    tq = qparams_from_jax(jax.tree.map(np.asarray, jq))
    predictor = make_predictor(tspec, tq, {}, *args, fold_bn=False, device="cpu")
    path = str(workdir / "int8_carried.zip")
    aot.save_detector_artifact(path, aot.export_detector(predictor.module, SIZE, ("cpu",)), {})
    jpredict, _ = jaot.load_detector_artifact(jpath)
    predict, _ = aot.load_detector_artifact(path, device="cpu")
    images = _toy_images()
    _assert_same_detections(predict(images), jpredict(images))


@pytest.fixture(scope="module")
def cli_artifact(workdir):
    """``cli export`` of the fp32 trained tiny for the CPU → (path, its
    printing, the config)."""
    config = workdir / "detect.yaml"
    cfg = _detect_config()
    config.write_text(yaml.safe_dump(cfg))
    out = str(workdir / "cli.zip")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(["export", "--config", str(config), "--out", out, "--platforms", "cpu"])
    return out, printed.getvalue(), cfg, str(config)


def test_cli_export_writes_a_loadable_artifact(cli_artifact, exported):
    path, printed, _, config = cli_artifact
    assert printed.startswith(f"wrote {path} (") and "platforms ['cpu']" in printed
    predict, manifest = aot.load_detector_artifact(path, device="cpu")
    assert manifest["source_config"] == config and manifest["model_name"] == "yolov3_tiny"
    assert manifest["class_names"] == open(NAMES).read().split()
    images = _images(30, 2)
    assert _equal(predict(images), exported["fp32"][0](images))


def test_manifest_keys_are_the_jax_manifests(cli_artifact, jax_artifact):
    with zipfile.ZipFile(cli_artifact[0]) as zf:
        manifest = json.loads(zf.read(aot.MANIFEST_NAME))
    jax_manifest = jax_artifact[1]
    # the port's own keys: its torch version, and the fp32 precision the loader pins
    assert (set(manifest) - {"torch_version", "fp32_precision"}
            == set(jax_manifest) - {"jax_version"})
    assert manifest["fp32_precision"] == "ieee"
    assert manifest["framework"] == "yolov3_tpu_torch" and jax_manifest["framework"] == "yolov3_tpu"
    assert manifest["torch_version"] == torch.__version__ and manifest["format_version"] == 1
    for key in ("model_name", "image_size", "class_names", "yolo_max_boxes", "nms_iou_threshold",
                "nms_score_threshold", "quantize", "compute_precision", "nms_per_class",
                "letterbox"):
        assert manifest[key] == jax_manifest[key], key


def test_loader_refuses_a_newer_format_and_a_jax_artifact(cli_artifact, jax_artifact, workdir):
    newer = str(workdir / "newer.zip")
    with zipfile.ZipFile(cli_artifact[0]) as src, zipfile.ZipFile(newer, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == aot.MANIFEST_NAME:
                data = json.dumps(dict(json.loads(data), format_version=2)).encode()
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="format_version 2"):
        aot.load_detector_artifact(newer, device="cpu")
    with pytest.raises(ValueError, match="artifact of the JAX package"):
        aot.load_detector_artifact(jax_artifact[0], device="cpu")


def test_loading_for_the_card_raises_without_one_or_without_its_program(cli_artifact):
    """No fallback: the default device is the card. Without one, loading
    raises; with one, this CPU-only artifact has no program for it."""
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="no program for cuda"):
            aot.load_detector_artifact(cli_artifact[0])
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            aot.load_detector_artifact(cli_artifact[0])
    with pytest.raises(RuntimeError if not torch.cuda.is_available() else ValueError):
        aot.load_detector_artifact(cli_artifact[0], device="cuda")


def _post(url, body):
    req = urllib.request.Request(f"{url}/detect", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_answers_from_an_artifact(cli_artifact):
    """``serve`` with ``artifact:`` alone (no model keys) answers /detect over
    HTTP with the detections of the server built from the model keys, and
    counts the request in /metrics."""
    path, _, cfg, _ = cli_artifact
    body = open(os.path.join(IMAGES, sorted(os.listdir(IMAGES))[0]), "rb").read()
    servers, answers = [], []
    try:
        for keys in (dict(artifact=path), dict(cfg)):
            httpd, app = Serve()(**keys, port=0, batch_buckets=[1, 2], serve_forever=False,
                                 device="cpu")
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            servers.append((httpd, app, thread))
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            answers.append(_post(url, body))
            if "artifact" in keys:
                with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
                    health = json.loads(r.read())
                with urllib.request.urlopen(f"{url}/metrics", timeout=10) as r:
                    metrics = r.read().decode()
    finally:
        for httpd, app, thread in servers:
            httpd.shutdown()
            app.shutdown()
            thread.join(10)
    assert not any(thread.is_alive() for _, _, thread in servers)
    from_artifact, from_keys = answers
    assert from_artifact["detections"] and from_artifact["detections"] == from_keys["detections"]
    assert (health["model"], health["image_size"], health["classes"]) == ("yolov3_tiny", SIZE, 3)
    assert "yolov3_requests_total 1\n" in metrics


@pytest.mark.parametrize("key,value", [("data_parallel", True), ("spatial_partitioning", 2)])
def test_artifact_with_parallel_keys_raises(cli_artifact, key, value):
    with pytest.raises(ValueError, match="artifact serving is single-device"):
        Serve()(artifact=cli_artifact[0], serve_forever=False, device="cpu", **{key: value})


def test_loading_and_running_imports_no_jax_and_no_model_code(cli_artifact):
    code = ("import sys, numpy as np; from yolov3_tpu_torch.export.aot import "
            "load_detector_artifact; "
            f"p, m = load_detector_artifact({cli_artifact[0]!r}, device='cpu'); "
            "out = p(np.zeros((2, m['image_size'], m['image_size'], 3), np.float32)); "
            "assert tuple(out[3].shape) == (2, 100), out[3].shape; "
            "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'yolov3_tpu') "
            "or n.startswith('yolov3_tpu_torch.models')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _op_cases():
    """(op, its arguments on the CPU) for each kernel's op, at small shapes."""
    rng = np.random.RandomState(3)

    def int8(*shape):
        return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.rand(*shape) * scale).astype(np.float32))

    boxes = f32(3, 40, 2)
    boxes = torch.cat([boxes, boxes + f32(3, 40, 2, scale=0.3)], -1)
    inv = torch.tensor(2.5)
    b, h, w, c, cm = 2, 3, 4, 64, 32
    scalars = [torch.tensor(v) for v in (19.3, 13.7, 0.0727, 0.0413, 16.4)]
    return {
        "suppression_sweep": (torch.ops.yolov3_torch.suppression_sweep.default,
                              (f32(3, 16, 16) > 0.6, f32(3, 16) > 0.2)),
        "round_sweep": (torch.ops.yolov3_torch.round_sweep.default,
                        (boxes, f32(3, 40), 0.5, 0.1, 12)),
        "conv1x1_int8_requant": (torch.ops.yolov3_torch.conv1x1_int8_requant.default,
                                 (int8(30, 32), int8(16, 32), f32(16, scale=1e-3), f32(16), inv,
                                  True, torch.int8)),
        "conv_int8": (torch.ops.yolov3_torch.conv_int8.default,
                      (int8(2, 7, 7, 16), int8(8, 3, 3, 16), f32(8, scale=1e-3), f32(8), None,
                       2, [1, 1, 1, 1], False, torch.float32)),
        "fused_resblock": (torch.ops.yolov3_torch.fused_resblock.default,
                           (resblock.to_halo(int8(b, h, w, c)), int8(cm, c), int8(9, c, cm) // 6,
                            f32(cm, scale=1e-3), f32(cm), scalars[0], f32(c, scale=1e-4), f32(c),
                            scalars[1], scalars[2], scalars[3], scalars[4], b, h, w)),
    }


@pytest.mark.parametrize("name", ["suppression_sweep", "round_sweep", "conv1x1_int8_requant",
                                  "conv_int8", "fused_resblock"])
def test_op_passes_opcheck_and_equals_the_plain_version_on_the_cpu(name):
    """``torch.library.opcheck`` (schema, fake kernel against the real one,
    and the op traced with a dynamic batch) on each kernel's op, and the op
    on CPU tensors is its plain version, bit for bit, with no launch."""
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
    plain = {"suppression_sweep": nms_kernel.suppression_sweep_ref,
             "round_sweep": round_sweep.round_sweep_ref,
             "conv1x1_int8_requant": lambda *a: conv1x1.conv1x1_int8_requant_plain(
                 *a[:5], leaky=a[5], out_dtype=a[6]),
             "conv_int8": lambda *a: conv_int8.conv_int8_plain(
                 *a[:5], stride=a[5], padding=(a[6][:2], a[6][2:]), leaky=a[7],
                 out_dtype=a[8]),
             "fused_resblock": lambda *a: resblock.fused_resblock_plain(
                 *a[:12], b=a[12], h=a[13], w=a[14])}[name]
    wrappers = (nms_kernel.suppression_sweep, round_sweep.round_sweep,
                conv1x1.conv1x1_int8_requant, conv_int8.conv_int8, resblock.fused_resblock)
    before = [w.launches for w in wrappers]
    got, want = op(*args), plain(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert _equal(got, want)
    assert [w.launches for w in wrappers] == before
