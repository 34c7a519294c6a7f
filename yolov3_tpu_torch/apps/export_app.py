"""Serving-artifact export application.

Counterpart of ``yolov3_tpu/apps/export_app.py``: drives ``export/aot.py``
from the detect/serve config schema, behind ``python -m
yolov3_tpu_torch.apps.cli export``. See ``export/aot.py`` for the artifact
format.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)


def export_artifact(config: dict, out: str, platforms=("cpu", "cuda")) -> dict:
    """Build the configured serving predictor, export it over a symbolic
    batch for each of ``platforms``, and write the artifact zip to ``out``.
    Returns the manifest.

    The predictor is built once, on the card when ``cuda`` is among the
    platforms and else on the CPU; an int8 tier calibrates there once and
    every platform's program carries the same quantized params."""
    from ..export.aot import export_detector, save_detector_artifact
    from .inference_app import build_serving_predictor

    if config.get("compilation_cache"):
        log.info("compilation_cache: nothing is compiled ahead of time here; no effect")
    image_size = int(config["image_size"])
    quantize = config.get("quantize")
    platforms = tuple(platforms)
    predictor, class_names, model_name = build_serving_predictor(
        config["model_config_file"], config["classes_name_file"],
        config["anchors_file"], config["input_weights_path"], image_size,
        config.get("yolo_max_boxes", 100),
        config.get("nms_iou_threshold", 0.5),
        config.get("nms_score_threshold", 0.3),
        quantize, config.get("compute_precision"),
        config.get("calibration_images_dir"),
        letterbox=bool(config.get("letterbox")),
        nms_per_class=bool(config.get("nms_per_class")),
        device="cuda" if "cuda" in platforms else "cpu")

    exported = export_detector(predictor.module, image_size, platforms=platforms)
    manifest = save_detector_artifact(out, exported, {
        "model_name": model_name,
        "image_size": image_size,
        "class_names": list(class_names),
        "yolo_max_boxes": int(config.get("yolo_max_boxes", 100)),
        "nms_iou_threshold": float(config.get("nms_iou_threshold", 0.5)),
        "nms_score_threshold": float(config.get("nms_score_threshold", 0.3)),
        "quantize": quantize,
        "compute_precision": config.get("compute_precision"),
        "nms_per_class": bool(config.get("nms_per_class")),
        "letterbox": bool(config.get("letterbox")),  # preprocessing hint
        "source_config": config.get("source_config"),
    })
    size_mb = os.path.getsize(out) / 1e6
    print(f"wrote {out} ({size_mb:.1f} MB, platforms {list(platforms)}, "
          f"model {manifest['model_name']}, image_size {image_size}, "
          f"quantize {quantize})")
    return manifest
