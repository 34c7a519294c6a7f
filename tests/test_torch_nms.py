"""The port's NMS (yolov3_tpu_torch/ops/nms.py) against the JAX package's
(yolov3_tpu/ops/nms.py), on the CPU: every branch of ``yolo_nms`` — the
matrix sweep, the K = N round sweep and the sorted-candidate round sweep —
with score ties and duplicate boxes, class-agnostic and per-class, plus
``yolo_nms_exact``'s escalation and ``gather_detections``.

Tolerance: none. Selected indices, counts, classes and scores are equal."""

import numpy as np
import pytest
import torch

from yolov3_tpu.ops import nms as jnms
from yolov3_tpu_torch.ops import nms as tnms

from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)


def _heads(seed, b, n, nc=3, size=0.25):
    """Decoded-head-like inputs with many exact score ties (objectness and
    class probs drawn from a few levels) and duplicate boxes."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2) * 0.8
    wh = rng.rand(b, n, 2) * size + 0.02
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 1::7] = boxes[:, 0:-1:7][:, : boxes[:, 1::7].shape[1]]
    conf = (np.round(rng.rand(b, n, 1) * 8) / 8).astype(np.float32)
    probs = (np.round(rng.rand(b, n, nc) * 6) / 6).astype(np.float32)
    return boxes, conf, probs


def _assert_same(j_out, t_out):
    jb, jc, js, jsel, jnv = map(np.asarray, j_out)
    tb, tc, ts, tsel, tnv = (t.numpy() for t in t_out)
    np.testing.assert_array_equal(tnv, jnv)
    np.testing.assert_array_equal(tsel, jsel)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tb, jb)


CASES = [
    # (n, num_candidates, max_boxes, score_thr, per_class)  branch
    (600, 512, 100, 0.1, False),    # matrix sweep, top-K truncation
    (600, 512, 100, 0.1, True),     # matrix sweep, per-class offsets
    (300, 512, 30, 0.0, False),     # matrix sweep, K = N (≤ 512)
    (300, 128, 200, 0.5, False),    # matrix sweep, fewer keeps than max_boxes
    (4200, 4200, 40, 0.2, False),   # round sweep at K = N > 4096
    (4200, 4200, 40, 0.2, True),    # … per-class
    (4300, 4160, 40, 0.05, False),  # round sweep over sorted candidates
    (3000, 2048, 100, 0.1, False),  # the port's round sweep against JAX's matrix sweep
]


@pytest.mark.parametrize("n,k,max_boxes,score_thr,per_class", CASES)
def test_yolo_nms_matches_jax(n, k, max_boxes, score_thr, per_class):
    boxes, conf, probs = _heads(n + k, 2, n)
    j_out = jnms.yolo_nms(boxes, conf, probs, max_boxes=max_boxes, iou_threshold=0.45,
                          score_threshold=score_thr, num_candidates=k,
                          per_class=per_class)
    t_out = tnms.yolo_nms(torch.from_numpy(boxes), torch.from_numpy(conf),
                          torch.from_numpy(probs), max_boxes=max_boxes,
                          iou_threshold=0.45, score_threshold=score_thr,
                          num_candidates=k, per_class=per_class)
    _assert_same(j_out, t_out)


def test_yolo_nms_exact_escalates_like_jax():
    """Low threshold, few candidates: both escalation loops must double K until the
    truncation provably cannot matter (1500 → 128, 256, …). Large boxes
    overlap a lot, so the top-128 keeps fewer than max_boxes."""
    boxes, conf, probs = _heads(7, 2, 1500, size=0.6)
    kw = dict(max_boxes=100, iou_threshold=0.5, score_threshold=0.004, num_candidates=128)
    j_out = jnms.yolo_nms_exact(boxes, conf, probs, **kw)
    t_out = tnms.yolo_nms_exact(torch.from_numpy(boxes), torch.from_numpy(conf),
                                torch.from_numpy(probs), **kw)
    _assert_same(j_out, t_out)
    # the escalation was needed: top-128 alone leaves the mask set
    t_k = tnms.yolo_nms(torch.from_numpy(boxes), torch.from_numpy(conf),
                        torch.from_numpy(probs), max_boxes=100, iou_threshold=0.5,
                        score_threshold=0.004, num_candidates=128)
    assert bool(tnms.nms_inexact_mask(t_k[2], t_k[4], 100, 0.004, 128).any())


@pytest.mark.parametrize("k,n,device,want", [
    (512, 10647, "cpu", 1024), (512, 10647, "cuda", 10647),
    (1024, 2535, "cuda", 2535), (128, 500, "cuda", 256), (2048, 2535, "cpu", 2535),
])
def test_next_escalation_k(k, n, device, want):
    assert tnms.next_escalation_k(k, n, device) == want


def test_gather_detections_matches_jax():
    boxes, conf, probs = _heads(3, 2, 400)
    j_out = jnms.yolo_nms(boxes, conf, probs, max_boxes=50, score_threshold=0.2)
    t_out = tnms.yolo_nms(*(torch.from_numpy(a) for a in (boxes, conf, probs)),
                          max_boxes=50, score_threshold=0.2)
    for j, t in zip(jnms.gather_detections(*j_out), tnms.gather_detections(*t_out)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
