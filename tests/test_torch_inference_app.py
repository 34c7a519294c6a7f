"""The port's batch inference (yolov3_tpu_torch/apps/inference_app.py
``Inference`` and the ``inference`` command), its image ops (ops/image.py),
its fused detection path (ops/detect.py), the int8 accuracy gate
(tools/int8_accuracy_gate.py) and the trainer's ``render_dataset_example``,
on the CPU, against the JAX package.

Tolerances:
  * ``Inference`` (trained YOLOv3-tiny, 128 px): ``detect.txt`` has the same
    lines with the same class names in the same order, its pixel boxes
    within 1e-4 of the rendered image's side; the returned normalized boxes
    and the scores within 1e-4 (float32 forward, convolutions summed in
    another order);
  * ``ops/image``: 1e-5 max abs (measured ≤ 1e-6);
  * ``ops/detect``: indices, classes and valid masks exact, boxes and scores
    1e-5; against the port's own decode ∘ yolo_nms ∘ gather_detections, the
    valid detections equal;
  * the gate: the same report keys, ``map50_bf16`` within 1e-3 (bf16 rounds
    differently in XLA:CPU and torch; measured 2e-4 apart at 128 px on 8
    images); ``map50_int8`` is printed, not held (calibration is not
    bit-portable between the two fp forwards);
  * ``dataset_example.png``: pixel-exact (same numpy renderer, no font).
"""

import ast
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from yolov3_tpu.apps.inference_app import Inference as JaxInference
from yolov3_tpu.data import pipeline as jpipe
from yolov3_tpu.ops import detect as jdetect
from yolov3_tpu.ops import image as jimage
from yolov3_tpu.utils.render import render_bboxes as jax_render_bboxes
from yolov3_tpu_torch.apps import cli
from yolov3_tpu_torch.apps.inference_app import Inference
from yolov3_tpu_torch.apps.train_app import Train
from yolov3_tpu_torch.config import get_anchors
from yolov3_tpu_torch.io.resolve import load_weights
from yolov3_tpu_torch.models import init_model, parse_model_config
from yolov3_tpu_torch.models.convert import params_to_jax
from yolov3_tpu_torch.ops import detect as tdetect
from yolov3_tpu_torch.ops import image as timage
from yolov3_tpu_torch.ops.decode import yolo_decode
from yolov3_tpu_torch.ops.nms import gather_detections, yolo_nms

from .conftest import REPO, absolutize_run_config
from .test_torch_data import native_decode_tier

SIZE = 128


def _detect_config(out_dir, **overrides):
    with open(os.path.join(REPO, "config/detect_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    for key in ("model_config_file", "tfrecords_dir", "classes_name_file", "anchors_file",
                "input_weights_path", "images_dir", "image_file_path"):
        cfg[key] = os.path.join(REPO, cfg[key])
    cfg.update(image_size=SIZE, batch_size=3, output_dir=str(out_dir))
    cfg.update(overrides)
    return cfg


@pytest.fixture(scope="module")
def odd_images(tmp_path_factory):
    """Four shapes_toy images cropped to other aspect ratios (PNG)."""
    d = tmp_path_factory.mktemp("odd_images")
    src = os.path.join(REPO, "datasets/shapes_toy/coco/images")
    for i, (name, box) in enumerate(zip(sorted(os.listdir(src))[:4],
                                        [(0, 0, 256, 160), (40, 0, 200, 256),
                                         (0, 30, 256, 230), (0, 0, 256, 256)])):
        Image.open(os.path.join(src, name)).crop(box).save(d / f"img_{i}.png")
    return str(d)


def _detect_lines(out_dir):
    with open(os.path.join(out_dir, "detect.txt")) as f:
        return [ast.literal_eval(line) for line in f]


CASES = {
    "tfrecords": dict(input_data_source="tfrecords"),
    "images_dir": dict(input_data_source="images_dir"),
    "images_dir-letterbox": dict(input_data_source="images_dir", letterbox=True),
    "image_file": dict(input_data_source="image_file"),
    "image_file-letterbox": dict(input_data_source="image_file", letterbox=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_inference_matches_jax(case, odd_images, tmp_path):
    overrides = dict(CASES[case], images_dir=odd_images,
                     image_file_path=os.path.join(odd_images, "img_0.png"))
    if case == "tfrecords":
        overrides["save_model_path"] = str(tmp_path / "saved")
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    with native_decode_tier():
        want = JaxInference()(**_detect_config(jax_dir, **overrides))
        got = Inference()(**_detect_config(port_dir, device="cpu", **overrides))

    n = {"tfrecords": 8, "images_dir": 4, "image_file": 1}[overrides["input_data_source"]]
    assert len(got) == len(want) == n
    jax_lines, port_lines = _detect_lines(jax_dir), _detect_lines(port_dir)
    assert len(port_lines) == len(jax_lines) == n
    assert sum(len(line) for line in port_lines) > 0
    for i, (g, w) in enumerate(zip(port_lines, jax_lines)):
        assert [d[0].split(":")[0] for d in g] == [d[0].split(":")[0] for d in w], i
        side = Image.open(port_dir / f"detect_{i}.jpg").size
        side = SIZE if not overrides.get("letterbox") else max(side)
        np.testing.assert_allclose(np.array([d[1:] for d in g]).reshape(-1, 4),
                                   np.array([d[1:] for d in w]).reshape(-1, 4),
                                   rtol=0, atol=1e-4 * side)
    for (gn, gb, gs), (wn, wb, ws) in zip(got, want):
        assert gn == wn
        np.testing.assert_allclose(gb, np.asarray(wb), rtol=0, atol=1e-4)
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=0, atol=1e-4)
    for i in range(n):
        got_img = Image.open(port_dir / f"detect_{i}.jpg")
        assert got_img.size == Image.open(jax_dir / f"detect_{i}.jpg").size
    assert (open(port_dir / "model_inference_summary.txt").read()
            == open(jax_dir / "model_inference_summary.txt").read())
    if case == "tfrecords":  # save_model_path wrote the loaded weights
        cfg = _detect_config(port_dir)
        spec = parse_model_config(cfg["model_config_file"], 3)
        fresh = init_model(spec, torch.Generator().manual_seed(1))
        saved = params_to_jax(*load_weights(spec, *fresh, str(tmp_path / "saved" / "model")))
        ckpt = params_to_jax(*load_weights(spec, *fresh, cfg["input_weights_path"]))
        for a, b in zip(jax.tree.leaves(saved), jax.tree.leaves(ckpt)):
            np.testing.assert_array_equal(a, b)


def test_inference_int8_chain_calibrates_from_the_source(tmp_path):
    """``quantize: int8_chain`` calibrates on the tfrecords it reads (the
    kernels' plain versions on the CPU); one line an image."""
    Inference()(**_detect_config(tmp_path, quantize="int8_chain", device="cpu"))
    assert len(_detect_lines(tmp_path)) == 8


def test_inference_video_mode(tmp_path):
    """``input_data_source: video_file``: frames batch like tfrecords (one
    zero-padded tail), the annotated stream lands in detect.mp4 at the
    source fps and size, detect.txt gets one line per frame, no jpgs."""
    cv2 = pytest.importorskip("cv2")
    src = os.path.join(REPO, "datasets/shapes_toy/coco/images")
    frames = [cv2.imread(os.path.join(src, f)) for f in sorted(os.listdir(src))[:6]]
    h, w = frames[0].shape[:2]
    video_in = str(tmp_path / "toy_in.mp4")
    writer = cv2.VideoWriter(video_in, cv2.VideoWriter_fourcc(*"mp4v"), 5.0, (w, h))
    assert writer.isOpened()
    for frame in frames:
        writer.write(frame)
    writer.release()

    out_dir = tmp_path / "video"
    results = Inference()(**_detect_config(out_dir, input_data_source="video_file",
                                           video_file_path=video_in, batch_size=4,
                                           device="cpu"))
    assert len(results) == 2  # the last batch's frames, none for the padding
    assert len(_detect_lines(out_dir)) == 6
    assert any(len(names) > 0 for names, _, _ in results)
    out = cv2.VideoCapture(str(out_dir / "detect.mp4"))
    assert out.isOpened()
    n = 0
    while True:
        ok, frame = out.read()
        if not ok:
            break
        assert frame.shape == (h, w, 3)
        n += 1
    out.release()
    assert n == 6
    assert not [f for f in os.listdir(out_dir) if f.endswith(".jpg")]


@pytest.mark.parametrize("key,value", [("data_parallel", True), ("spatial_partitioning", 2)])
def test_parallel_keys_raise(tmp_path, key, value, monkeypatch):
    """Both keys keep the JAX package's rules. ``data_parallel`` with an
    image source that predicts one image at a time raises its
    ``ValueError``; ``spatial_partitioning`` alone is valid there (the data
    axis collapses to 1) and writes the plain run's ``detect.txt``. Over
    tfrecords each key runs on one device (the CPU: ``data_parallel`` a
    no-op, the two bands sharing it) and over two (two CPU replicas
    standing in for two cards: a batch of 4 as 2 + 2, or each image's rows
    as two bands), and writes the plain run's ``detect.txt``."""
    if key == "spatial_partitioning":
        per_image = dict(device="cpu", input_data_source="images_dir", image_size=96)
        Inference()(**_detect_config(tmp_path / "dir_plain", **per_image))
        Inference()(**_detect_config(tmp_path / "dir", **per_image, **{key: value}))
        _assert_same_detections(_detect_lines(tmp_path / "dir"),
                                _detect_lines(tmp_path / "dir_plain"))
    else:
        with pytest.raises(ValueError,
                           match="data_parallel requires a batched input_data_source"):
            Inference()(**_detect_config(tmp_path, device="cpu", input_data_source="images_dir",
                                         **{key: value}))
    cfg = dict(image_size=96, batch_size=4, input_data_source="tfrecords", device="cpu")
    Inference()(**_detect_config(tmp_path / "plain", **cfg))
    Inference()(**_detect_config(tmp_path / "one", **cfg, **{key: value}))
    from yolov3_tpu_torch.apps import inference_app

    monkeypatch.setattr(inference_app, "local_devices", lambda kind: (torch.device(kind),) * 2)
    Inference()(**_detect_config(tmp_path / "two", **cfg, **{key: value}))
    want = _detect_lines(tmp_path / "plain")
    if key == "data_parallel":
        assert want and _detect_lines(tmp_path / "one") == want == _detect_lines(tmp_path / "two")
    for run in ("one", "two"):
        _assert_same_detections(_detect_lines(tmp_path / run), want)


def _assert_same_detections(got, want):
    """detect.txt lines of two runs: the same labels in the same order, the
    boxes within 1e-5 of the 256-pixel source images (a band or a shard is
    another shape for the CPU's convolutions)."""
    assert want and len(got) == len(want)
    for g, w in zip(got, want):
        assert [d[0] for d in g] == [d[0] for d in w]
        np.testing.assert_allclose([d[1:] for d in g], [d[1:] for d in w], rtol=0,
                                   atol=256 * 1e-5)


def test_inference_command(tmp_path):
    cfg = tmp_path / "detect.yaml"
    cfg.write_text(yaml.safe_dump(_detect_config(tmp_path / "out", image_size=96)))
    cli.main(["inference", "--config", str(cfg), "--device", "cpu"])
    assert len(_detect_lines(tmp_path / "out")) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["inference", "--config", str(cfg)])


@pytest.mark.parametrize("shape,out", [((37, 53, 3), (64, 96)), ((64, 96, 3), (37, 53)),
                                       ((2, 41, 29, 3), (128, 128)),
                                       ((2, 130, 211, 3), (96, 96)), ((5, 7, 3), (416, 416))])
def test_image_ops_match_jax(shape, out):
    x = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    for name in ("resize_bilinear", "letterbox_resize"):
        want = np.asarray(getattr(jimage, name)(jnp.asarray(x), *out))
        got = getattr(timage, name)(torch.from_numpy(x), *out).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("seed,grids,k", [(0, (4, 8, 16), 128), (1, (13, 26), 256),
                                          (2, (5, 10, 20), 64)])
def test_detect_matches_jax_and_the_unfused_path(seed, grids, k):
    rng = np.random.default_rng(seed)
    nc = 3
    anchors = get_anchors(os.path.join(REPO, "datasets/coco2012/anchors.txt"))[:len(grids)]
    heads = [rng.normal(0, 2, (2, g, g, 3, 5 + nc)).astype(np.float32) for g in grids]
    kw = dict(max_boxes=20, iou_threshold=0.5, score_threshold=0.1, num_candidates=k)
    want = [np.asarray(a) for a in jdetect.detect([jnp.asarray(h) for h in heads],
                                                  jnp.asarray(anchors), nc, **kw)]
    theads = [torch.from_numpy(h) for h in heads]
    got = [t.numpy() for t in tdetect.detect(theads, anchors, nc, **kw)]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    assert got[3].sum() > 0
    unfused = gather_detections(*yolo_nms(*yolo_decode(theads, anchors, nc), **kw))
    valid = got[3]
    np.testing.assert_array_equal(unfused[3].numpy(), valid)
    for a, b in zip(unfused[:3], got[:3]):
        np.testing.assert_array_equal(a.numpy()[valid], b[valid])


def test_int8_gate_matches_jax():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import int8_accuracy_gate as jax_gate

    from yolov3_tpu_torch.tools import int8_accuracy_gate as port_gate

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with native_decode_tier():
            want = jax_gate.run_gate(max_images=8, image_size=SIZE)
            got = port_gate.run_gate(max_images=8, image_size=SIZE, device="cpu")
    finally:
        os.chdir(cwd)
    print(f"JAX {want}\nport {got}")
    assert got.keys() == want.keys() and got["images"] == 8
    assert abs(got["map50_bf16"] - want["map50_bf16"]) <= 1e-3
    assert got["matched_detections"] > 0 and isinstance(got["gate_pass"], bool)


def test_render_dataset_example_matches_jax(tmp_path):
    with open(os.path.join(REPO, "config/train_config.yaml")) as f:
        cfg = absolutize_run_config(yaml.safe_load(f))
    cfg.update(image_size=96, batch_size=8, epochs=1, max_dataset_examples=8,
               render_dataset_example=True, device="cpu",
               output_checkpoints_path=str(tmp_path / "tiny.tf"))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with native_decode_tier():
            Train()(**cfg)
    finally:
        os.chdir(cwd)
    got = np.asarray(Image.open(tmp_path / "dataset_example.png"))
    with native_decode_tier():
        (ds_train, _), _ = jpipe.create_dataset(cfg["dataset_config"], 96, cfg["max_bboxes"],
                                                cfg["classes_name_file"], 8)
        images, labels = next(iter(jpipe.Batcher(ds_train, 1)))
    rendered = jax_render_bboxes(images[0], labels[0][labels[0][:, 4] == 1][:, :4])
    want = np.uint8(np.clip(rendered, 0, 1) * 255)
    assert got.shape == want.shape == (96, 96, 3)
    np.testing.assert_array_equal(got, want)
