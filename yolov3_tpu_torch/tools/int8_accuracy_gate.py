"""int8-vs-bf16 accuracy gate on the trained toy checkpoint + shapes val set.

Counterpart of the JAX package's ``tools/int8_accuracy_gate.py``. Runs the
SAME weights through the bf16 predictor and the int8 PTQ predictor (int8
weights per channel, activations calibrated on the first 4 images) over the
shapes_toy validation tfrecords, then reports:
  * mAP@0.5 for both tiers (APAccumulator),
  * score agreement on matched detections (max |Δscore|),
  * box agreement (mean IoU of position-matched detections),
and ``gate_pass`` when the two mAPs differ by at most 0.01. The repo has no
trained full-width weights, so the gate uses the bundled tiny checkpoint
trained on shapes_toy.

Usage (from anywhere; relative paths resolve against the repo root):
  python -m yolov3_tpu_torch.tools.int8_accuracy_gate [--max_images 32] [--device cpu]
A COCO-json split instead of tfrecords (e.g. the bundled pets_mini):
  python -m yolov3_tpu_torch.tools.int8_accuracy_gate \\
    --model_config config/models/yolov3/model.yaml \\
    --ckpt checkpoints/output/yolov3_train_pets.tf \\
    --names datasets/pets_breed.names --anchors datasets/coco2012/anchors.txt \\
    --val_images_dir datasets/pets_mini/valid \\
    --val_annotations datasets/pets_mini/valid/_annotations.coco.json
Runs on the CUDA card unless given ``--device cpu``; there the int8 convs run
through the hand-written kernels (K3, K6).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

DEFAULTS = dict(
    model_config="config/models/yolov3_tiny/model.yaml",
    ckpt="checkpoints/output/yolov3_train_tiny.tf",
    names="datasets/shapes_toy/class.names",
    anchors="datasets/shapes_toy/anchors/anchors_tiny.txt",
    val_tfrecords="datasets/shapes_toy/tfrecords/val",
)


def run_gate(max_images=32, image_size=416, score_threshold=0.1,
             model_config=DEFAULTS["model_config"], ckpt=DEFAULTS["ckpt"],
             names=DEFAULTS["names"], anchors_file=DEFAULTS["anchors"],
             val_tfrecords=DEFAULTS["val_tfrecords"],
             val_images_dir=None, val_annotations=None, device=None):
    from ..apps.inference_app import make_predictor
    from ..config import get_anchors, read_class_names
    from ..data.tfrecord import parse_tfrecords
    from ..eval.detections_evaluator import APAccumulator, _np_iou_one
    from ..io.resolve import load_weights
    from ..models import init_model, parse_model_config

    nclasses = len(read_class_names(names))
    spec = parse_model_config(model_config, nclasses=nclasses)
    anchors = get_anchors(anchors_file)
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    params, state = load_weights(spec, params, state, ckpt)

    if val_images_dir:  # COCO-json split (e.g. the bundled pets_mini)
        from ..data.coco_json import create_dataset_from_files

        ds, _ = create_dataset_from_files(val_images_dir, val_annotations,
                                          image_size, max_images, max_bboxes=100)
        it = iter(ds)
    else:
        it = parse_tfrecords(val_tfrecords, image_size, 100, names)
    examples = []
    for im, lb in it:
        examples.append((np.asarray(im), np.asarray(lb)))
        if len(examples) >= max_images:
            break
    # parse_tfrecords already yields square image_size images (stretch
    # resize — the geometry the labels' normalized coords live in)
    images = np.stack([im for im, _ in examples]).astype(np.float32)
    labels = [lb for _, lb in examples]

    calib = [images[:4]]
    preds = {}
    for tier, kwargs in [
        ("bf16", dict(compute_dtype=torch.bfloat16)),
        ("int8", dict(quantize="int8", calibration_batches=calib)),
    ]:
        predict = make_predictor(spec, params, state, anchors, nclasses, 100,
                                 0.5, score_threshold, device=device, **kwargs)
        bboxes, cls, scores, selected, nvalid = (t.cpu().numpy() for t in predict(images))
        acc = APAccumulator(nclasses=nclasses)
        dets = []
        for i in range(len(images)):
            nv = int(nvalid[i])
            sel = selected[i, :nv]
            db, dc, ds = bboxes[i][sel], cls[i][sel], scores[i][sel]
            lb = labels[i]
            gt = lb[lb[:, 4] > 0]
            acc.add_image(db, dc, ds, gt[:, :4], gt[:, 5].astype(np.int32))
            dets.append((db, dc, ds))
        _, mean_ap = acc.compute()
        preds[tier] = {"dets": dets, "map50": mean_ap}

    m_bf16 = preds["bf16"]["map50"]
    m_int8 = preds["int8"]["map50"]

    score_deltas, ious = [], []
    for (db, dc, ds), (qb, qc, qs) in zip(preds["bf16"]["dets"], preds["int8"]["dets"]):
        for j in range(len(db)):
            if len(qb) == 0:
                continue
            iou = _np_iou_one(db[j], qb)
            k = int(np.argmax(iou))
            if iou[k] > 0.5:
                ious.append(float(iou[k]))
                score_deltas.append(abs(float(ds[j]) - float(qs[k])))

    return {
        "images": len(images),
        "map50_bf16": round(m_bf16, 4),
        "map50_int8": round(m_int8, 4),
        "map50_delta": round(m_int8 - m_bf16, 4),
        "matched_detections": len(ious),
        "mean_matched_iou": round(float(np.mean(ious)), 4) if ious else None,
        "max_abs_score_delta": round(float(np.max(score_deltas)), 4) if score_deltas else None,
        "gate_pass": bool(abs(m_int8 - m_bf16) <= 0.01),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.int8_accuracy_gate")
    ap.add_argument("--max_images", type=int, default=32)
    ap.add_argument("--image_size", type=int, default=416)
    ap.add_argument("--score_threshold", type=float, default=0.1)
    ap.add_argument("--model_config", default=DEFAULTS["model_config"])
    ap.add_argument("--ckpt", default=DEFAULTS["ckpt"])
    ap.add_argument("--names", default=DEFAULTS["names"])
    ap.add_argument("--anchors", default=DEFAULTS["anchors"])
    ap.add_argument("--val_tfrecords", default=DEFAULTS["val_tfrecords"])
    ap.add_argument("--val_images_dir", default=None,
                    help="COCO-json alternative to --val_tfrecords")
    ap.add_argument("--val_annotations", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    os.chdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    print(json.dumps(run_gate(args.max_images, args.image_size,
                              args.score_threshold, args.model_config,
                              args.ckpt, args.names, args.anchors,
                              args.val_tfrecords, args.val_images_dir,
                              args.val_annotations, device=args.device), indent=2))


if __name__ == "__main__":
    main()
