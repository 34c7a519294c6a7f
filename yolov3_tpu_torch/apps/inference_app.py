"""Serving predictor: BN-folded forward + decode + NMS as one callable.

Counterpart of the predictor half of ``yolov3_tpu/apps/inference_app.py``
(``make_predictor``, ``calibration_batches_from_dir``,
``build_serving_predictor``, ``gather_valid_detections``): the fp32 and
bf16 tiers and the int8 PTQ tiers (``quantize: int8`` / ``int8_chain``).
The JAX package compiles the pipeline into one jit; here it runs eagerly on
the device, and on the card the NMS sweeps and every int8 convolution go
through the hand-written CUDA kernels (``ops/nms.py``,
``models/layers.py::conv2d_int8``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import dir_filelist, get_anchors, read_class_names
from ..data.image import decode_image, letterbox_resize, resize_bilinear
from ..device import resolve_device
from ..io.resolve import load_weights
from ..models import apply_model, fold_batch_norm, init_model, parse_model_config
from ..models.network import to_device
from ..ops.decode import yolo_decode
from ..ops.nms import yolo_nms
from ..ops.quantize import calibrate_scales, quantize_params
from ..ops.s2d import s2d_stem

_DTYPES = {"bf16": torch.bfloat16, "fp32": None, None: None}


def make_predictor(spec, params, bn_state, anchors_table, nclasses, yolo_max_boxes,
                   nms_iou_threshold, nms_score_threshold, fold_bn: bool = True,
                   compute_dtype=None, quantize=None, calibration_batches=None,
                   image_size=None, nms_per_class: bool = False, device=None):
    """Build ``predict(images)``: (B, H, W, 3) float images (numpy or tensor)
    → the ``yolo_nms`` tuple of tensors on ``device``.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) casts weights and images for
    the forward; decode and NMS run in float32 as in the JAX package.

    ``quantize='int8'`` is the int8 PTQ tier: per-channel int8 weights and
    calibrated per-tensor activation scales; every quantized conv quantizes
    its fp input and emits fp. ``quantize='int8_chain'`` keeps activations
    int8 between convs (each conv's epilogue requantizes, shortcuts are a
    dequant-add-requant). Both need ``calibration_batches`` (a list of
    (B, H, W, 3) float arrays) and ``fold_bn``, run the forward in float32
    whatever ``compute_dtype`` says, and apply the bit-exact space-to-depth
    stem rewrite (``ops/s2d.py``; pass ``image_size`` so odd sizes skip it).
    Calibration runs on ``device``.
    """
    dev = resolve_device(device)
    run_params = fold_batch_norm(params, bn_state) if fold_bn else params
    run_state = {} if fold_bn else to_device(bn_state, dev)
    if quantize in ("int8", "int8_chain"):
        if not fold_bn:
            raise ValueError("int8 quantization requires fold_bn=True")
        if not calibration_batches:
            raise ValueError("int8 quantization needs calibration_batches")
        run_params = to_device(run_params, dev)
        batches = [np.asarray(b, np.float32) for b in calibration_batches]
        in_absmax, out_absmax = calibrate_scales(spec, run_params, batches)
        run_params = quantize_params(
            spec, run_params, in_absmax,
            out_absmax=out_absmax if quantize == "int8_chain" else None)
        spec, run_params = s2d_stem(spec, run_params, image_size=image_size)
        compute_dtype = None
    elif quantize is not None:
        raise ValueError(f"quantize must be None, 'int8' or 'int8_chain', got {quantize!r}")
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


def calibration_batches_from_dir(images_dir, image_size, limit: int = 8, preprocess=None):
    """int8-calibration batches from a directory of images (square resize,
    /255 — the ``image_file`` preprocessing; pass ``preprocess`` to match a
    letterboxed pipeline)."""
    preprocess = preprocess or resize_bilinear
    calib = []
    for file in dir_filelist(images_dir, (".jpeg", ".jpg", ".png", ".bmp"))[:limit]:
        with open(file, "rb") as f:
            img = decode_image(f.read()).astype(np.float32) / 255.0
        calib.append(preprocess(img, image_size, image_size))
    if not calib:
        raise ValueError(f"no calibration images in {images_dir}")
    return [np.stack(calib)]


def build_serving_predictor(model_config_file, classes_name_file, anchors_file,
                            input_weights_path, image_size, yolo_max_boxes=100,
                            nms_iou_threshold=0.5, nms_score_threshold=0.3,
                            quantize=None, compute_precision=None,
                            calibration_images_dir=None, letterbox=False,
                            nms_per_class=False, device=None, seed=None):
    """Detect-config keys → ``(predictor, class_names, model_name)``.

    ``quantize: int8`` / ``int8_chain`` calibrates on the images of
    ``calibration_images_dir`` (``letterbox`` selects the calibration
    geometry to match the caller's preprocessing).

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
    calibration_batches = None
    if quantize in ("int8", "int8_chain"):
        if not calibration_images_dir:
            raise ValueError(f"quantize: {quantize} needs calibration_images_dir")
        calibration_batches = calibration_batches_from_dir(
            calibration_images_dir, image_size,
            preprocess=letterbox_resize if letterbox else None)
    predictor = make_predictor(
        spec, params, bn_state, anchors_table, len(class_names), yolo_max_boxes,
        nms_iou_threshold, nms_score_threshold,
        compute_dtype=_DTYPES[compute_precision], quantize=quantize,
        calibration_batches=calibration_batches, image_size=image_size,
        nms_per_class=nms_per_class, device=device)
    model_name = os.path.basename(os.path.dirname(model_config_file)) or "yolov3"
    return predictor, class_names, model_name


def gather_valid_detections(bboxes, class_indices, scores, selected, num_valid):
    """reference inference.py:21-28 — one image's valid detections."""
    sel = selected[: int(num_valid)]
    return bboxes[sel], class_indices[sel], scores[sel]
