"""The port's evaluator (yolov3_tpu_torch/eval/) against the JAX package's,
on the CPU, and the port's framework-neutral copies pinned to their originals.

  * the batched matcher ``evaluate_image_counters`` on seeded padded batches
    that hold the reference's quirks: several predictions on one gt (all TP),
    a negative gt class (the image only counts in ``errors``), an image with
    no valid gt (every IoU row -1), predictions with an ``inf`` and a ``NaN``
    box, exact IoU ties between gts of different classes (first index wins),
    class ids out of range (clipped before the scatter);
  * ``EvaluateDetections`` over two batches: counters, per-image histograms
    and ``recall_precision``;
  * ``APAccumulator`` / ``CocoAPAccumulator`` on the same detections.

Tolerance: none — counters, histograms and the float64 APs are identical."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.eval import detections_evaluator as jev
from yolov3_tpu_torch.eval import detections_evaluator as tev

from .conftest import REPO
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

NCLASSES = 4


def _batch(seed, b=6, p=12, g=5):
    """Seeded padded predictions and gts with the matcher's corner cases."""
    rng = np.random.default_rng(seed)

    def boxes(*shape):
        xy = rng.uniform(0.0, 0.7, (*shape, 2))
        wh = rng.uniform(0.05, 0.3, (*shape, 2))
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)

    gt_boxes = boxes(b, g)
    gt_classes = rng.integers(0, NCLASSES, (b, g)).astype(np.int32)
    gt_valid = rng.random((b, g)) < 0.8
    pred_boxes = boxes(b, p)
    # half the predictions sit near a gt of the same image
    near = rng.integers(0, g, (b, p))
    jitter = rng.normal(0, 0.02, (b, p, 4)).astype(np.float32)
    on_gt = rng.random((b, p)) < 0.5
    pred_boxes = np.where(on_gt[..., None],
                          np.take_along_axis(gt_boxes, near[..., None], 1) + jitter,
                          pred_boxes).astype(np.float32)
    pred_classes = np.where(rng.random((b, p)) < 0.7,
                            np.take_along_axis(gt_classes, near, 1),
                            rng.integers(0, NCLASSES, (b, p))).astype(np.int32)
    pred_valid = rng.random((b, p)) < 0.85

    # image 0: two predictions exactly on one gt, same class — both TP
    gt_valid[0, 0] = True
    pred_boxes[0, 0] = pred_boxes[0, 1] = gt_boxes[0, 0]
    pred_classes[0, 0] = pred_classes[0, 1] = gt_classes[0, 0]
    pred_valid[0, :2] = True
    # image 1: a valid gt with a negative class — only 'errors' counts
    gt_valid[1, 2], gt_classes[1, 2] = True, -1
    # image 2: no valid gt (every IoU row is -1, argmax takes index 0)
    gt_valid[2] = False
    # image 3: an inf box and a NaN box, both valid predictions; a padded gt
    # with a negative class does not make an error
    pred_boxes[3, 0] = [0.1, 0.1, np.inf, 0.5]
    pred_boxes[3, 1] = [np.nan, 0.2, 0.4, 0.4]
    pred_valid[3, :2] = True
    gt_valid[3, 4], gt_classes[3, 4] = False, -3
    # image 4: two identical gts of different classes (an exact IoU tie, the
    # first wins), one prediction on them of the second gt's class (FP)
    # and one of the first's (TP); a prediction class out of range
    gt_boxes[4, 1] = gt_boxes[4, 0]
    gt_valid[4, :2] = True
    gt_classes[4, 0], gt_classes[4, 1] = 1, 2
    pred_boxes[4, 0] = pred_boxes[4, 1] = gt_boxes[4, 0]
    pred_classes[4, 0], pred_classes[4, 1] = 2, 1
    pred_valid[4, :3] = True
    pred_classes[4, 2] = NCLASSES + 3
    # image 5: every prediction padded
    pred_valid[5] = False
    return pred_boxes, pred_classes, pred_valid, gt_boxes, gt_classes, gt_valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matcher_counters_identical_to_jax(seed):
    args = _batch(seed)
    want = jev.evaluate_image_counters(*map(jnp.asarray, args), NCLASSES, jnp.float32(0.5))
    got = tev.evaluate_image_counters(*map(torch.from_numpy, args), NCLASSES, 0.5)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    # the corner cases did what they are there for
    assert int(got["tp"][0].sum()) >= 2 and int(got["errors"][1]) == 1
    assert int(got["examples"][1]) == 0 and int(got["gts"][1].sum()) == 0
    assert int(got["gts"][2].sum()) == 0 and int(got["fn"][2].sum()) == 0
    assert int(got["preds"][5].sum()) == 0


def test_evaluate_detections_identical_to_jax():
    jax_eval, port_eval = jev.EvaluateDetections(NCLASSES), tev.EvaluateDetections(NCLASSES)
    for seed in (3, 4):
        args = _batch(seed)
        jax_eval.evaluate_batch(*args)
        port_eval.evaluate_batch(*(torch.from_numpy(a) for a in args))
    assert jax_eval.counters.keys() == port_eval.counters.keys()
    for key, want in jax_eval.counters.items():
        np.testing.assert_array_equal(port_eval.counters[key], want, err_msg=key)
    for name in ("preds_histo", "gt_histo", "tp_histo", "fp_histo", "fn_histo"):
        np.testing.assert_array_equal(np.stack(getattr(port_eval, name)),
                                      np.stack(getattr(jax_eval, name)), err_msg=name)
    for got, want in zip(port_eval.recall_precision(), jax_eval.recall_precision()):
        np.testing.assert_array_equal(got, want)


def test_ap_accumulators_identical_to_jax():
    rng = np.random.default_rng(5)
    accs = [(jev.APAccumulator(NCLASSES), tev.APAccumulator(NCLASSES)),
            (jev.CocoAPAccumulator(NCLASSES), tev.CocoAPAccumulator(NCLASSES))]
    pb, pc, pv, gb, gc, gv = _batch(6)
    for i in range(len(pb)):
        scores = rng.random(pb.shape[1]).astype(np.float32)
        record = (pb[i][pv[i]], pc[i][pv[i]], scores[pv[i]], gb[i][gv[i]], gc[i][gv[i]])
        for jax_acc, port_acc in accs:
            jax_acc.add_image(*record)
            port_acc.add_image(*record)
    for jax_acc, port_acc in accs:
        for got, want in zip(port_acc.compute(), jax_acc.compute()):
            np.testing.assert_array_equal(got, want)
    assert accs[0][1].compute()[1] > 0


NOTE = ("\n\nFramework-neutral copy of ``yolov3_tpu/{name}`` (the port imports nothing of the\n"
        "JAX package). tests/test_torch_eval.py pins it to its original.\n")


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


@pytest.mark.parametrize("name", ["eval/coco_export.py", "eval/plots.py", "utils/render.py",
                                  "client.py", "exceptions.py"])
def test_neutral_copies_match_originals(name):
    copy = _read("yolov3_tpu_torch", name)
    note = NOTE.format(name=name)
    assert copy.count(note) == 1
    original = _read("yolov3_tpu", name)
    # the note ends the docstring, whose closing quotes the original keeps
    # on the last text line or on a line of their own
    assert copy.replace(note, "", 1) in (original, original.replace('\n"""', '"""', 1))


@pytest.mark.parametrize("name", ["eval/__init__.py", "utils/__init__.py"])
def test_package_inits_match_originals(name):
    assert _read("yolov3_tpu_torch", name) == _read("yolov3_tpu", name)
