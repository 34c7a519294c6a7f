"""The port's serving slice end to end on the CPU, against the JAX package:
``build_serving_predictor`` + ``DetectionApp`` on config/serve_config.yaml
(yolov3_tiny, the in-repo trained checkpoint) at 128 px, the HTTP server
through ``Serve`` (fp32 and the int8 tier), and the port's import boundary
(no jax, no yolov3_tpu).

Tolerance: selected indices, counts and classes identical; boxes and
scores 1e-4 absolute (float32 forward, convolutions summed in another
order)."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from yolov3_tpu.apps.inference_app import build_serving_predictor as jax_build
from yolov3_tpu.config import load_yaml
from yolov3_tpu_torch.apps.inference_app import build_serving_predictor
from yolov3_tpu_torch.apps.serve_app import DetectionApp, Serve
from yolov3_tpu_torch.data.image import decode_image, resize_bilinear

from .conftest import REPO, absolutize_run_config
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

SIZE = 128
# the shapes_toy checkpoint's scores top out near 0.26, under the config's
# 0.3: serve at 0.1 so real detections come back
SCORE_THR = 0.1
KEYS = ("model_config_file", "classes_name_file", "anchors_file", "input_weights_path",
        "image_size", "yolo_max_boxes", "nms_iou_threshold", "nms_score_threshold")


def _serve_cfg():
    cfg = absolutize_run_config(load_yaml(os.path.join(REPO, "config/serve_config.yaml")))
    cfg["input_weights_path"] = os.path.join(REPO, cfg["input_weights_path"])
    cfg.update(image_size=SIZE, nms_score_threshold=SCORE_THR)
    return cfg


def _image_files(n):
    d = os.path.join(REPO, "datasets/shapes_toy/coco/images")
    return [os.path.join(d, f) for f in sorted(os.listdir(d))[:n]]


@pytest.fixture(scope="module")
def predictors():
    cfg = {k: _serve_cfg()[k] for k in KEYS}
    jax_pred, jnames, _ = jax_build(**cfg)
    pred, names, model_name = build_serving_predictor(**cfg, device="cpu")
    assert names == jnames and model_name == "yolov3_tiny"
    return jax_pred, pred, names


def test_predictor_matches_jax_serving_predictor(predictors):
    jax_pred, pred, _ = predictors
    images = np.stack([resize_bilinear(decode_image(open(f, "rb").read()) / 255.0,
                                       SIZE, SIZE) for f in _image_files(2)])
    jb, jc, js, jsel, jnv = map(np.asarray, jax_pred(images))
    tb, tc, ts, tsel, tnv = (t.numpy() for t in pred(images))
    assert (tnv > 0).all()
    np.testing.assert_array_equal(tnv, jnv)
    np.testing.assert_array_equal(tsel, jsel)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4)


def test_detection_app_matches_jax(predictors):
    """Concurrent encoded requests through the port's batcher (buckets 1, 2,
    zero-padded groups) give each image the JAX predictor's detections."""
    jax_pred, pred, names = predictors
    files = _image_files(4)
    app = DetectionApp(pred, names, SIZE, batch_buckets=(1, 2), batch_timeout_ms=50)
    try:
        results = [None] * len(files)

        def worker(i):
            results[i] = app.detect(open(files[i], "rb").read())

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(files))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        app.shutdown()
    for f, res in zip(files, results):
        img = resize_bilinear(decode_image(open(f, "rb").read()) / 255.0, SIZE, SIZE)
        jb, jc, js, jsel, jnv = map(np.asarray, jax_pred(img[None]))
        sel = jsel[0][: int(jnv[0])]
        assert [d["class_id"] for d in res["detections"]] == jc[0][sel].tolist()
        np.testing.assert_allclose([d["box_normalized"] for d in res["detections"]],
                                   jb[0][sel], rtol=0, atol=1e-4)
        np.testing.assert_allclose([d["score"] for d in res["detections"]],
                                   js[0][sel], rtol=0, atol=1e-4)
    assert app.stats.snapshot()["requests"] == len(files)


def test_serve_http_endpoint_on_cpu():
    cfg = _serve_cfg()
    cfg.update(port=0, batch_buckets=[1, 2], serve_forever=False, device="cpu")
    httpd, app = Serve()(**cfg)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        Image.open(_image_files(1)[0]).save(buf, format="PNG")
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        req = urllib.request.Request(f"{url}/detect", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["detections"] and body["width"] > 0
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["device"] == "cpu" and health["batch_buckets"] == [1, 2]
    finally:
        httpd.shutdown()
        app.shutdown()
        thread.join(10)
    assert not thread.is_alive()


def test_serve_int8_tier_on_cpu():
    """One request through ``Serve`` with ``quantize: int8`` on the CPU,
    calibrated on the shapes_toy images: the int8 tier answers with
    detections (each conv quantized, here through the kernels' plain
    versions) and says so on /healthz."""
    cfg = _serve_cfg()
    cfg.update(port=0, batch_buckets=[1], serve_forever=False, device="cpu", quantize="int8",
               calibration_images_dir=os.path.join(REPO, "datasets/shapes_toy/coco/images"))
    httpd, app = Serve()(**cfg)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        req = urllib.request.Request(f"{url}/detect", data=open(_image_files(1)[0], "rb").read(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["detections"] and all(0 <= d["score"] <= 1 for d in body["detections"])
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
            assert json.loads(r.read())["quantize"] == "int8"
    finally:
        httpd.shutdown()
        app.shutdown()
        thread.join(10)
    assert not thread.is_alive()


@pytest.mark.parametrize("extra", [{"data_parallel": True}, {"spatial_partitioning": 2}])
def test_later_slices_raise(extra, monkeypatch):
    """Both keys are ported with the JAX package's semantics.
    ``data_parallel`` is a no-op on one device (the CPU); over two devices
    (two CPU replicas standing in for two cards) every bucket must divide by
    them. ``spatial_partitioning: 2`` splits each image's rows in two bands,
    sharing the one device or one a device; the image size must divide by
    it. Each sharded server answers as the plain one (the same detections,
    boxes and scores within 1e-5: a shard is another shape for the CPU's
    convolutions)."""
    cfg = _serve_cfg()
    cfg.update(serve_forever=False, device="cpu", port=0, warmup=False, batch_buckets=[2, 4])
    body = open(_image_files(1)[0], "rb").read()
    answers = []
    for devices in (1, 2):
        if devices == 2:
            from yolov3_tpu_torch.parallel import mesh as tmesh

            monkeypatch.setattr(tmesh, "local_devices", lambda kind: (torch.device(kind),) * 2)
        for parallel in (False, True):
            httpd, app = Serve()(**cfg, **(extra if parallel else {}))
            try:
                answers.append(app.detect(body)["detections"])
            finally:
                app.shutdown()
                httpd.server_close()
    assert answers[0]
    for got in answers[1:]:
        assert [d["class_id"] for d in got] == [d["class_id"] for d in answers[0]]
        for key in ("score", "box_normalized"):
            np.testing.assert_allclose([d[key] for d in got], [d[key] for d in answers[0]],
                                       rtol=0, atol=1e-5)
    if "data_parallel" in extra:
        with pytest.raises(ValueError, match=r"batch_buckets \[1\] not divisible by the "
                                             r"data-axis size \(2 = 2 devices / spatial 1\)"):
            Serve()(**dict(cfg, batch_buckets=[1, 2]), data_parallel=True)
    else:
        with pytest.raises(ValueError, match=r"spatial_partitioning \(3\) must divide the "
                                             r"device count \(2\)"):
            Serve()(**dict(cfg, spatial_partitioning=3))
        monkeypatch.setattr(tmesh, "local_devices", lambda kind: (torch.device(kind),))
        with pytest.raises(ValueError, match=r"image_size \(128\) must be divisible by "
                                             r"spatial_partitioning \(3\)"):
            Serve()(**dict(cfg, spatial_partitioning=3))


def test_port_imports_no_jax():
    code = ("import sys; import yolov3_tpu_torch.apps.serve_app, yolov3_tpu_torch.apps.cli, "
            "yolov3_tpu_torch.io, yolov3_tpu_torch.models.convert, "
            "yolov3_tpu_torch.ops.quantize, yolov3_tpu_torch.ops.s2d, "
            "yolov3_tpu_torch.ops.cuda.conv1x1, yolov3_tpu_torch.ops.cuda.conv_int8, "
            "yolov3_tpu_torch.ops.cuda.resblock, yolov3_tpu_torch.apps.evaluate_app, "
            "yolov3_tpu_torch.apps.inference_app, yolov3_tpu_torch.apps.train_app, "
            "yolov3_tpu_torch.eval, yolov3_tpu_torch.eval.coco_export, "
            "yolov3_tpu_torch.eval.plots, yolov3_tpu_torch.ops.image, "
            "yolov3_tpu_torch.ops.detect, yolov3_tpu_torch.utils.render, "
            "yolov3_tpu_torch.client, yolov3_tpu_torch.exceptions, "
            "yolov3_tpu_torch.tools.int8_accuracy_gate, yolov3_tpu_torch.io.darknet, "
            "yolov3_tpu_torch.apps.convert_app, yolov3_tpu_torch.export, "
            "yolov3_tpu_torch.export.tfjs_graph, yolov3_tpu_torch.tools.bn_recalibrate, "
            "yolov3_tpu_torch.tools.average_checkpoints, "
            "yolov3_tpu_torch.tools.convert_tf_checkpoint, yolov3_tpu_torch.tools.export_tfjs, "
            "yolov3_tpu_torch.export.aot, yolov3_tpu_torch.apps.export_app, "
            "yolov3_tpu_torch.parallel.mesh, yolov3_tpu_torch.parallel.spatial, "
            "yolov3_tpu_torch.device; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'yolov3_tpu' or m.startswith('yolov3_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env.pop("YOLOV3_TPU_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_predictor_without_card_raises_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = {k: _serve_cfg()[k] for k in KEYS}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serving_predictor(**cfg)
