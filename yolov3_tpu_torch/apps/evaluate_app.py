"""Evaluation application — the reference evaluate_yolov3.py capability.

Counterpart of ``yolov3_tpu/apps/evaluate_app.py``. Reads
evaluate_config.yaml (the nms score-threshold sweep) + detect_config.yaml
(model/dataset/NMS keys). For each threshold: batched prediction, padded
matching on the device, per-class recall/precision, per-image histograms
saved as .npy (tp_<thr>.npy etc.) in the working directory, plus an overall
'oneclass' run with classes zeroed (bbox-only quality), mAP@0.5 (or
mAP@[.5:.95] with ``coco_map``), an optional ``results_json`` summary and a
COCO export of the lowest threshold.

The thresholds are arguments of one predictor, built once. The fp forward
runs in float32, as in the JAX package; only ``tools/int8_accuracy_gate.py``
measures the int8 tier's mAP. The exact-K policy escalates the top-K of NMS
whenever the truncation could have changed a result
(``ops/nms.py::next_escalation_k``): on the card straight to K = N, which is
the round-sweep kernel (K2); on the CPU by doubling, as the JAX package does
there. Runs on the card unless ``detect_config`` says ``device: cpu`` or the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from ..config import get_anchors, read_class_names
from ..data.native_build import ensure_native_library
from ..data.tfrecord import parse_tfrecords
from ..device import pin_fp32_ieee, resolve_device
from ..eval.detections_evaluator import APAccumulator, CocoAPAccumulator, EvaluateDetections
from ..io.resolve import load_weights
from ..models import apply_model, fold_batch_norm, init_model, parse_model_config
from ..models.network import to_device
from ..ops.decode import yolo_decode
from ..ops.nms import DEFAULT_NUM_CANDIDATES, next_escalation_k, nms_inexact_mask, yolo_nms
from .inference_app import data_parallel_mesh

log = logging.getLogger(__name__)


def make_sweepable_predictor(spec, params, bn_state, anchors_table, nclasses,
                             yolo_max_boxes, nms_per_class=False, device=None, mesh=None):
    """``predict(images, iou_threshold, score_threshold, num_candidates)`` →
    the ``yolo_nms`` tuple of tensors on ``device``: BN-folded float32
    forward (IEEE fp32 on the card, ``device.pin_fp32_ieee``), decode and
    NMS, the thresholds plain arguments.
    ``nms_per_class``: per-class suppression (extension; the reference — and
    the default — is class-agnostic). ``mesh``: data-parallel evaluation, a
    copy of the params on the first device of each data replica of the mesh
    (then ``device`` is not read), the batch split evenly over them and the
    answers gathered in batch order on the first; with a spatial axis each
    replica's forward runs in bands of rows over its band devices
    (``inference_app.make_predictor``)."""
    groups = ([(resolve_device(device),)] if mesh is None
              else [tuple(resolve_device(d) for d in bands) for bands in mesh.replicas])
    folded = fold_batch_norm(params, bn_state)
    replicas = []
    for bands in groups:
        for dev in bands:
            pin_fp32_ieee(dev)
        replicas.append((to_device(folded, bands[0]), torch.as_tensor(
            np.asarray(anchors_table), dtype=torch.float32, device=bands[0]),
            bands if len(bands) > 1 else None))

    scales = spec.head_scales()

    def run(x, run_params, anchors, bands, iou_threshold, score_threshold, num_candidates):
        outputs = apply_model(spec, run_params, {}, x, devices=bands)
        boxes, conf, probs = yolo_decode(outputs, anchors, nclasses, scales)
        return yolo_nms(boxes, conf, probs, max_boxes=yolo_max_boxes,
                        iou_threshold=iou_threshold, score_threshold=score_threshold,
                        num_candidates=num_candidates, per_class=nms_per_class)

    @torch.inference_mode()
    def predict(images, iou_threshold, score_threshold,
                num_candidates=DEFAULT_NUM_CANDIDATES):
        if mesh is None:
            x = torch.as_tensor(images, device=groups[0][0]).float()
            return run(x, *replicas[0], iou_threshold, score_threshold, num_candidates)
        parts = mesh.shard_batch(torch.as_tensor(images).float())
        outs = [run(x, *replica, iou_threshold, score_threshold, num_candidates)
                for x, replica in zip(parts, replicas)]
        return tuple(mesh.gather_batch(list(field)) for field in zip(*outs))

    return predict


def _selected_to_padded(bboxes, class_idx, scores, selected, num_valid, max_boxes):
    """NMS outputs → fixed (max_boxes,) padded preds + valid mask, batched."""
    idx = selected.long()
    pred_boxes = torch.gather(bboxes, 1, idx[..., None].expand(-1, -1, 4))
    pred_classes = torch.gather(class_idx, 1, idx)
    pred_scores = torch.gather(scores, 1, idx)
    valid = torch.arange(max_boxes, device=idx.device)[None, :] < num_valid[:, None]
    return pred_boxes, pred_classes, pred_scores, valid


def _jsonable(v):
    if isinstance(v, np.ndarray):
        v = v.ravel().tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (np.floating, np.integer)):
        v = v.item()
    if isinstance(v, float) and np.isnan(v):
        return None  # NaN is not valid JSON
    return v


def evaluate(evaluate_config: dict, detect_config: dict, max_eval_images=None,
             evaluate_iou_threshold: float = 0.5, compute_map: bool = True,
             coco_map: bool = False, device=None):
    """Run the sweep; returns one result dict per threshold (recall,
    precision, wall_seconds, images_per_sec, counters, counters_oneclass,
    and ap_per_class / map50 [/ map50_95] unless ``compute_map`` is off)."""
    if detect_config.get("compilation_cache"):
        log.info("compilation_cache: nothing is compiled ahead of time here; no effect")
    dev = resolve_device(device if device is not None else detect_config.get("device"))
    ensure_native_library()  # the TFRecords' decoding library

    thresholds = evaluate_config["evaluate_nms_score_thresholds"]
    # COCO interchange export for the lowest sweep threshold — max recall,
    # the right input for external re-scoring (eval/coco_export.py)
    coco_export_dir = evaluate_config.get("coco_export_dir")
    export_threshold = min(thresholds) if coco_export_dir else None

    anchors_table = get_anchors(detect_config["anchors_file"])
    class_names = read_class_names(detect_config["classes_name_file"])
    nclasses = len(class_names)
    image_size = detect_config["image_size"]
    batch_size = detect_config["batch_size"]
    yolo_max_boxes = detect_config["yolo_max_boxes"]
    nms_iou_threshold = detect_config["nms_iou_threshold"]

    spec = parse_model_config(detect_config["model_config_file"], nclasses)
    params, bn_state = init_model(spec, torch.Generator().manual_seed(0))
    params, bn_state = load_weights(spec, params, bn_state, detect_config["input_weights_path"])
    # data_parallel: the batch shards over every local device (a no-op on
    # one); spatial_partitioning: each image's rows split into bands
    mesh = data_parallel_mesh(detect_config.get("data_parallel"), batch_size, dev,
                              detect_config.get("spatial_partitioning"))
    predict = make_sweepable_predictor(
        spec, params, bn_state, anchors_table, nclasses, yolo_max_boxes,
        nms_per_class=bool(detect_config.get("nms_per_class")), device=dev, mesh=mesh)

    # dataset: tfrecords, gt kept padded + masked (fixed shapes).
    # parse_tfrecords already yields square image_size images, so the
    # reference's letterbox (inference.py:119-123) would be the identity
    def batches():
        images, labels = [], []
        count = 0
        for img, lab in parse_tfrecords(detect_config["tfrecords_dir"], image_size,
                                        yolo_max_boxes, detect_config["classes_name_file"]):
            images.append(img)
            labels.append(lab)
            count += 1
            if len(images) == batch_size:
                yield np.stack(images), np.stack(labels), batch_size
                images, labels = [], []
            if max_eval_images and count >= max_eval_images:
                break
        if images:
            pad = batch_size - len(images)
            yield (
                np.stack(images + [np.zeros_like(images[0])] * pad),
                np.stack(labels + [np.zeros_like(labels[0])] * pad),
                len(images),
            )

    results = []
    for score_threshold in thresholds:
        evaluator = EvaluateDetections(nclasses, evaluate_iou_threshold)
        evaluator_oneclass = EvaluateDetections(nclasses, evaluate_iou_threshold)
        ap_acc = None
        if coco_map:
            ap_acc = CocoAPAccumulator(nclasses)
        elif compute_map:
            ap_acc = APAccumulator(nclasses, evaluate_iou_threshold)
        exporter = None
        if score_threshold == export_threshold:
            from ..eval.coco_export import CocoExporter

            exporter = CocoExporter(class_names, image_size)

        # exact-K policy: escalate whenever the top-K truncation could have
        # diverged from the full NMS. K is sticky across batches within a
        # threshold (a threshold that trips it on one batch trips it on nearly
        # all), so later batches skip the discarded low-K pass.
        k = DEFAULT_NUM_CANDIDATES
        t_thresh, n_eval_images = time.time(), 0
        for images, labels, n_real in batches():
            n_eval_images += n_real
            out = predict(images, nms_iou_threshold, score_threshold, num_candidates=k)
            n_cand = out[2].shape[1]
            while k < n_cand and bool(nms_inexact_mask(
                    out[2], out[4], yolo_max_boxes, score_threshold, k).any()):
                k = next_escalation_k(k, n_cand, dev)
                log.info(f"NMS top-K escalation to K={k} at score_threshold="
                         f"{score_threshold} (exactness guarantee)")
                out = predict(images, nms_iou_threshold, score_threshold, num_candidates=k)
            pb, pc, ps, pv = _selected_to_padded(*out, yolo_max_boxes)
            lab = torch.from_numpy(labels).to(dev)
            gt_boxes = lab[..., 0:4]
            gt_classes = lab[..., 5].to(torch.int32)
            gt_valid = lab[..., 4] != 0
            # drop the zero-padded tail images by COUNT (inferring realness
            # from gt/preds would count a padding image as real whenever the
            # net hallucinates a detection on a blank input)
            r = slice(0, n_real)
            evaluator.evaluate_batch(pb[r], pc[r], pv[r], gt_boxes[r], gt_classes[r], gt_valid[r])
            evaluator_oneclass.evaluate_batch(
                pb[r], torch.zeros_like(pc[r]), pv[r],
                gt_boxes[r], torch.zeros_like(gt_classes[r]), gt_valid[r])
            if ap_acc is None and exporter is None:
                continue
            pb, pc, ps, pv = (t[r].cpu().numpy() for t in (pb, pc, ps, pv))
            gb, gc, gv = (t[r].cpu().numpy() for t in (gt_boxes, gt_classes, gt_valid))
            for i in range(n_real):
                for sink in (ap_acc, exporter):
                    if sink is not None:
                        sink.add_image(pb[i][pv[i]], pc[i][pv[i]], ps[i][pv[i]],
                                       gb[i][gv[i]], gc[i][gv[i]])

        # wall throughput of the pass (prediction + matching)
        wall_s = time.time() - t_thresh
        recall, precision = evaluator.recall_precision()
        print("Results Bbox and Classes:")
        for key, v in evaluator.counters.items():
            print(f" {key}: {v}", end="")
        print("\nResults Bbox Only (Single Class):")
        for key, v in evaluator_oneclass.counters.items():
            print(f" {key}: {v}", end="")
        print(f"\nrecall: {recall}, precision: {precision}")
        entry = {"score_threshold": score_threshold, "recall": recall, "precision": precision,
                 "wall_seconds": round(wall_s, 2),
                 "images_per_sec": round(n_eval_images / wall_s, 2) if wall_s else None,
                 "counters": {key: np.asarray(v).tolist()
                              for key, v in evaluator.counters.items()},
                 "counters_oneclass": {key: np.asarray(v).tolist()
                                       for key, v in evaluator_oneclass.counters.items()}}
        if ap_acc is not None:
            if coco_map:
                aps, map5095, map50 = ap_acc.compute()
                print(f"mAP@[.5:.95]: {map5095:.4f}  mAP@0.5: {map50:.4f}")
                entry["ap_per_class"] = aps
                entry["map50"] = map50
                entry["map50_95"] = map5095
            else:
                aps, mean_ap = ap_acc.compute()
                print(f"mAP@0.5: {mean_ap:.4f}")
                entry["ap_per_class"] = aps
                entry["map50"] = mean_ap
            for name, ap in zip(class_names, aps):
                if not np.isnan(ap):
                    print(f"  AP[{name}]: {ap:.4f}")
        results.append(entry)

        if exporter is not None:
            det_path, gt_path = exporter.write(coco_export_dir)
            print(f"COCO export ({len(exporter.images)} images, "
                  f"score_threshold {score_threshold}): {det_path}, {gt_path}")

        np.save(f"preds_{score_threshold}", np.stack(evaluator.preds_histo))
        np.save(f"gts_{score_threshold}", np.stack(evaluator.gt_histo))
        np.save(f"tp_{score_threshold}", np.stack(evaluator.tp_histo))
        np.save(f"fp_{score_threshold}", np.stack(evaluator.fp_histo))
        np.save(f"fn_{score_threshold}", np.stack(evaluator.fn_histo))

    print([(r["recall"], r["precision"]) for r in results])

    # machine-readable sweep summary (extension; the reference only prints
    # and dumps per-class .npy histograms — evaluate_yolov3.py:214-236)
    results_json = evaluate_config.get("results_json")
    if results_json:
        parent = os.path.dirname(results_json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        payload = {
            "class_names": list(class_names),
            "evaluate_iou_threshold": float(evaluate_iou_threshold),
            "nms_iou_threshold": float(nms_iou_threshold),
            "sweep": [{key: _jsonable(v) for key, v in r.items()} for r in results],
        }
        with open(results_json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote evaluation summary to {results_json}")
    return results
