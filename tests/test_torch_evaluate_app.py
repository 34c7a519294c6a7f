"""The port's evaluation app (yolov3_tpu_torch/apps/evaluate_app.py and the
``evaluate`` command) against the JAX package's, on the CPU, with the
trained YOLOv3-tiny checkpoint on shapes_toy ``tfrecords/test``,
``batch_size`` 8 and ``max_eval_images`` 6 (one zero-padded tail batch):

  * 128 px, thresholds [0.004, 0.1], mAP@0.5, ``results_json`` and the COCO
    export. At 128 px N = 240 candidates, under the first top-K of 512, so
    neither package escalates;
  * 224 px (N = 735), threshold 0.004, ``coco_map``: the truncation at
    K = 512 could change an image there, so both escalate to K = 735 (on the
    CPU the port doubles, capped at N, as the JAX package does).

Tolerance: the escalations (thresholds and K), the counters (class-aware and
one-class), the five per-image ``.npy`` histograms of each threshold, the AP
per class, mAP@0.5, mAP@[.5:.95] and the ``results_json`` payload (less
``wall_seconds`` / ``images_per_sec``) identical; the COCO export's
``ground_truth.json`` identical and its detections the same per image in
number and class, boxes within 1e-4 of the image size and scores within
1e-4. Greedy NMS is discontinuous: if an image's histograms differ, the test
prints the near-tie that explains it and fails when there is none: a
decision of NMS that flips between the two packages' decoded outputs within
1e-4 of its threshold (a score across the score threshold, a swap in the
top-K order, an IoU across the NMS threshold; ``chip_smoke.near_tie_witness``)
or a detection–gt IoU within 1e-4 of the evaluation's 0.5."""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.apps import evaluate_app as jax_app
from yolov3_tpu.io.resolve import load_weights as jax_load
from yolov3_tpu.models import init_model as jax_init
from yolov3_tpu.models import parse_model_config as jax_parse
from yolov3_tpu_torch.apps import cli, inference_app
from yolov3_tpu_torch.apps import evaluate_app as port_app
from yolov3_tpu_torch.config import get_anchors
from yolov3_tpu_torch.data.tfrecord import parse_tfrecords
from yolov3_tpu_torch.eval import detections_evaluator as tev
from yolov3_tpu_torch.io.resolve import load_weights
from yolov3_tpu_torch.models import init_model, parse_model_config
from yolov3_tpu_torch.ops import nms as tnms

import chip_smoke

from .conftest import REPO
from .test_torch_data import native_decode_tier

MAX_IMAGES = 6
NEAR_TIE = 1e-4
CASES = {
    "128": dict(size=128, thresholds=[0.004, 0.1], coco_map=False),
    "224-coco-map": dict(size=224, thresholds=[0.004], coco_map=True),
}
HISTOGRAMS = ("preds", "gts", "tp", "fp", "fn")


def _detect_config(size):
    with open(os.path.join(REPO, "config/detect_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    for key in ("model_config_file", "tfrecords_dir", "classes_name_file", "anchors_file",
                "input_weights_path"):
        cfg[key] = os.path.join(REPO, cfg[key])
    cfg.update(image_size=size, batch_size=8)
    return cfg


class _Escalations(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        if "escalation" in record.getMessage():
            self.lines.append(record.getMessage())


def _run(package, case, workdir):
    """One package's sweep, run in its own working directory (the .npy
    histograms land there) → (results, escalation log lines, workdir)."""
    os.makedirs(workdir)
    evaluate_config = {"evaluate_nms_score_thresholds": case["thresholds"],
                       "results_json": os.path.join(workdir, "results.json"),
                       "coco_export_dir": os.path.join(workdir, "coco")}
    app, kwargs = (jax_app, {}) if package == "jax" else (port_app, {"device": "cpu"})
    handler = _Escalations()
    logger = logging.getLogger(app.__name__)
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        results = app.evaluate(evaluate_config, _detect_config(case["size"]),
                               max_eval_images=MAX_IMAGES, coco_map=case["coco_map"], **kwargs)
    finally:
        os.chdir(cwd)
        logger.removeHandler(handler)
        logger.setLevel(level)
    return results, handler.lines, workdir


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tmp_path_factory):
    case = CASES[request.param]
    root = str(tmp_path_factory.mktemp(f"evaluate_{request.param}"))
    with native_decode_tier():
        return case, _run("jax", case, os.path.join(root, "jax")), \
            _run("port", case, os.path.join(root, "port"))


def _near_ties(case, thr, image):
    """Why ``image`` may differ at score threshold ``thr``: the decisions of
    greedy NMS that flip between the two packages' decoded outputs
    (``chip_smoke.near_tie_witness``: a score across the threshold, the first
    swap in the top-K order, an IoU across the NMS threshold), and the
    detection–gt IoUs of either package within ``NEAR_TIE`` of the
    evaluation's 0.5. Returns (witness, eval IoUs near 0.5)."""
    cfg = _detect_config(case["size"])
    with native_decode_tier():
        img, lab = next(x for i, x in enumerate(parse_tfrecords(
            cfg["tfrecords_dir"], case["size"], 100, cfg["classes_name_file"])) if i == image)
    anchors = get_anchors(cfg["anchors_file"])
    jspec = jax_parse(cfg["model_config_file"], 3)
    jp = jax_load(jspec, *jax_init(jax.random.PRNGKey(0), jspec), cfg["input_weights_path"])
    jout = jax_app.make_sweepable_predictor(jspec, *jp, anchors, 3, 100)(
        jnp.asarray(img[None]), jnp.float32(0.5), jnp.float32(thr), num_candidates=10**6)
    tspec = parse_model_config(cfg["model_config_file"], 3)
    tp = load_weights(tspec, *init_model(tspec, torch.Generator().manual_seed(0)),
                      cfg["input_weights_path"])
    tout = port_app.make_sweepable_predictor(tspec, *tp, anchors, 3, 100, device="cpu")(
        img[None], 0.5, thr, num_candidates=10**6)
    jout = [torch.from_numpy(np.array(o)) for o in jout]
    witness = chip_smoke.near_tie_witness(tnms, jout[0][0], jout[2][0], tout[0][0], tout[2][0],
                                          dict(score_threshold=thr, iou_threshold=0.5))
    gt = torch.from_numpy(lab[lab[:, 4] != 0][:, :4])[None]
    eval_ties = []
    for out in (jout, tout):
        dets = out[0][0][out[3][0, : int(out[4][0])].long()][None]
        iou = tev._pairwise_iou(dets, gt)
        eval_ties += iou[(iou - 0.5).abs() < NEAR_TIE].tolist()
    return witness, eval_ties


def _differing_images(case, jax_dir, port_dir):
    """{threshold: [image indices whose histograms differ]}."""
    out = {}
    for thr in case["thresholds"]:
        rows = np.zeros(MAX_IMAGES, bool)
        for name in HISTOGRAMS:
            want = np.load(os.path.join(jax_dir, f"{name}_{thr}.npy"))
            got = np.load(os.path.join(port_dir, f"{name}_{thr}.npy"))
            assert got.shape == want.shape == (MAX_IMAGES, 3), name
            rows |= (got != want).any(axis=1)
        if rows.any():
            out[thr] = np.nonzero(rows)[0].tolist()
    return out


def test_escalations_match(runs):
    case, (_, jax_lines, _), (_, port_lines, _) = runs
    assert port_lines == jax_lines
    if case["size"] == 224:
        assert port_lines == ["NMS top-K escalation to K=735 at score_threshold=0.004 "
                              "(exactness guarantee)"]
    else:
        assert port_lines == []


def test_counters_histograms_and_ap_match(runs):
    case, (jax_res, _, jax_dir), (port_res, _, port_dir) = runs
    differing = _differing_images(case, jax_dir, port_dir)
    for thr, images in differing.items():
        for image in images:
            witness, eval_ties = _near_ties(case, thr, image)
            print(f"threshold {thr}, image {image} differs: NMS {witness}, "
                  f"evaluation IoUs near 0.5 {eval_ties}")
            margin = witness["margin"]
            assert eval_ties or (margin is not None and margin <= NEAR_TIE), \
                f"image {image} differs at threshold {thr} with no near-tie"
    if differing:
        return
    assert len(port_res) == len(jax_res) == len(case["thresholds"])
    for got, want in zip(port_res, jax_res):
        assert got.keys() == want.keys()
        assert got["counters"] == want["counters"]
        assert got["counters_oneclass"] == want["counters_oneclass"]
        for key in ("recall", "precision", "ap_per_class"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["map50"] == want["map50"]
        if case["coco_map"]:
            assert got["map50_95"] == want["map50_95"]
        assert got["counters"]["examples"] == MAX_IMAGES


def test_results_json_matches(runs):
    _, (_, _, jax_dir), (_, _, port_dir) = runs
    want, got = (json.load(open(os.path.join(d, "results.json"))) for d in (jax_dir, port_dir))
    for payload in (want, got):
        for entry in payload["sweep"]:
            assert entry.pop("wall_seconds") > 0
            entry.pop("images_per_sec")
    assert got == want


def test_coco_export_matches(runs):
    case, (_, _, jax_dir), (_, _, port_dir) = runs
    coco = [os.path.join(d, "coco") for d in (jax_dir, port_dir)]
    want_gt, got_gt = (json.load(open(os.path.join(d, "ground_truth.json"))) for d in coco)
    assert got_gt == want_gt and len(got_gt["images"]) == MAX_IMAGES
    want, got = (json.load(open(os.path.join(d, "detections.json"))) for d in coco)
    assert len(got) == len(want) > 0
    key = lambda d: (d["image_id"], d["category_id"])  # noqa: E731
    assert [key(d) for d in got] == [key(d) for d in want]
    size = case["size"]
    np.testing.assert_allclose(np.array([d["bbox"] for d in got]) / size,
                               np.array([d["bbox"] for d in want]) / size, rtol=0, atol=1e-4)
    np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want],
                               rtol=0, atol=1e-4)


def test_data_parallel_keys_raise(tmp_path, monkeypatch):
    """Both keys are ported. ``data_parallel``: on one device (the CPU) a
    no-op, and over two devices (two CPU replicas standing in for two cards)
    the batch of 8 shards 4 + 4. ``spatial_partitioning: 2``: each image's
    rows in two bands, sharing the one device or one band a device. Every
    run answers as the plain sweep, counters and mAP equal; a factor that
    does not divide the devices raises the JAX package's message."""
    monkeypatch.chdir(tmp_path)  # the .npy histograms land in the working directory
    sweep = {"evaluate_nms_score_thresholds": [0.1]}
    plain = port_app.evaluate(sweep, _detect_config(128), max_eval_images=8, device="cpu")
    runs = []
    for devices in (1, 2):
        if devices == 2:
            monkeypatch.setattr(inference_app, "local_devices",
                                lambda kind: (torch.device(kind),) * 2)
        for key in ({"data_parallel": True}, {"spatial_partitioning": 2}):
            runs.append(port_app.evaluate(sweep, dict(_detect_config(128), **key),
                                          max_eval_images=8, device="cpu"))
    for got in runs:
        for a, b in zip(got, plain):
            assert a["counters"] == b["counters"] and a["map50"] == b["map50"]
    with pytest.raises(ValueError, match=r"spatial_partitioning \(3\) must divide the device "
                                         r"count \(2\)"):
        port_app.evaluate(sweep, dict(_detect_config(128), spatial_partitioning=3),
                          device="cpu")


def test_evaluate_command_on_cpu(tmp_path, capsys):
    detect = tmp_path / "detect.yaml"
    detect.write_text(yaml.safe_dump(_detect_config(96)))
    sweep = tmp_path / "evaluate.yaml"
    sweep.write_text(yaml.safe_dump({"evaluate_nms_score_thresholds": [0.2]}))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cli.main(["evaluate", "--evaluate_config", str(sweep), "--detect_config", str(detect),
                  "--max_eval_images", "3", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out
    assert "mAP@0.5:" in out and "Results Bbox and Classes:" in out
    assert np.load(tmp_path / "gts_0.2.npy").shape == (3, 3)


def test_evaluate_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device exists")
    detect = tmp_path / "detect.yaml"
    detect.write_text(yaml.safe_dump(_detect_config(96)))
    sweep = tmp_path / "evaluate.yaml"
    sweep.write_text(yaml.safe_dump({"evaluate_nms_score_thresholds": [0.2]}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["evaluate", "--evaluate_config", str(sweep), "--detect_config", str(detect)])
