"""Serving predictor: BN-folded forward + decode + NMS as one callable.

Counterpart of the predictor half of ``yolov3_tpu/apps/inference_app.py``
(``make_predictor``, ``build_serving_predictor``,
``gather_valid_detections``), fp32 and bf16 tiers. The JAX package
compiles the pipeline into one jit; here it runs eagerly on the device,
and the NMS sweeps go through the hand-written CUDA kernels on the card
(``ops/nms.py``). The int8 PTQ tier is a later slice of the port.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import get_anchors, read_class_names
from ..device import resolve_device
from ..io.resolve import load_weights
from ..models import apply_model, fold_batch_norm, init_model, parse_model_config
from ..models.network import to_device
from ..ops.decode import yolo_decode
from ..ops.nms import yolo_nms

_DTYPES = {"bf16": torch.bfloat16, "fp32": None, None: None}


def _int8_not_ported(quantize):
    if quantize is not None:
        raise NotImplementedError(
            f"quantize: {quantize!r} is the int8 serving tier, which the port "
            "carries in its int8 slice (ops/quantize.py, ops/s2d.py and the "
            "int8 kernels); serve fp32 or compute_precision: bf16")


def make_predictor(spec, params, bn_state, anchors_table, nclasses, yolo_max_boxes,
                   nms_iou_threshold, nms_score_threshold, fold_bn: bool = True,
                   compute_dtype=None, quantize=None, nms_per_class: bool = False,
                   device=None):
    """Build ``predict(images)``: (B, H, W, 3) float images (numpy or tensor)
    → the ``yolo_nms`` tuple of tensors on ``device``.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) casts weights and images for
    the forward; decode and NMS run in float32 as in the JAX package.
    """
    _int8_not_ported(quantize)
    dev = resolve_device(device)
    run_params = fold_batch_norm(params, bn_state) if fold_bn else params
    run_state = {} if fold_bn else to_device(bn_state, dev)
    run_params = to_device(run_params, dev, compute_dtype)
    anchors = torch.as_tensor(np.asarray(anchors_table), dtype=torch.float32, device=dev)

    @torch.inference_mode()
    def predict_fn(images):
        x = torch.as_tensor(images, device=dev)
        x = x.to(compute_dtype or torch.float32)
        outputs = apply_model(spec, run_params, run_state, x)
        boxes, conf, probs = yolo_decode(outputs, anchors, nclasses)
        return yolo_nms(boxes, conf, probs, max_boxes=yolo_max_boxes,
                        iou_threshold=nms_iou_threshold,
                        score_threshold=nms_score_threshold, per_class=nms_per_class)

    predict_fn.device = dev
    return predict_fn


def build_serving_predictor(model_config_file, classes_name_file, anchors_file,
                            input_weights_path, image_size, yolo_max_boxes=100,
                            nms_iou_threshold=0.5, nms_score_threshold=0.3,
                            quantize=None, compute_precision=None,
                            nms_per_class=False, device=None, seed=None):
    """Detect-config keys → ``(predictor, class_names, model_name)``.

    ``input_weights_path`` is a native ``.npz`` checkpoint (JAX key layout).
    ``input_weights_path=None`` with a ``seed`` serves Keras-default weights
    drawn from ``torch.Generator().manual_seed(seed)`` — for runs that need
    the full-width model but have no trained weights for it.
    """
    anchors_table = get_anchors(anchors_file)
    class_names = read_class_names(classes_name_file)
    spec = parse_model_config(model_config_file, len(class_names))
    params, bn_state = init_model(spec, torch.Generator().manual_seed(
        0 if seed is None else int(seed)))
    if input_weights_path is not None:
        params, bn_state = load_weights(spec, params, bn_state, input_weights_path)
    elif seed is None:
        raise ValueError("build_serving_predictor needs input_weights_path or a seed")
    predictor = make_predictor(
        spec, params, bn_state, anchors_table, len(class_names), yolo_max_boxes,
        nms_iou_threshold, nms_score_threshold,
        compute_dtype=_DTYPES[compute_precision], quantize=quantize,
        nms_per_class=nms_per_class, device=device)
    model_name = os.path.basename(os.path.dirname(model_config_file)) or "yolov3"
    return predictor, class_names, model_name


def gather_valid_detections(bboxes, class_indices, scores, selected, num_valid):
    """reference inference.py:21-28 — one image's valid detections."""
    sel = selected[: int(num_valid)]
    return bboxes[sel], class_indices[sel], scores[sel]
