"""Batched inference throughput of one card: YOLOv3 at 416² through the
forward (BN folded) + decode + NMS + detection gather, the whole pipeline
on the device.

Counterpart of the JAX package's root ``bench.py``, with its knobs read from
the environment:

    BENCH_BATCH (128)  BENCH_IMAGE_SIZE (416)  BENCH_ITERS (32 batches a pass)
    BENCH_QUANTIZE (int8 | int8_chain | bf16)  BENCH_PATH (classic | fused)
    BENCH_MODEL (yolov3 | yolov3_tiny | ...)

    python -m yolov3_tpu_torch.tools.bench [--device cpu]

Prints one JSON line: ``metric``, ``value`` (images/s of the best of 3
passes), ``unit``, ``vs_baseline`` and ``device`` (the card's name, count
and power limit, or ``"cpu"``).

Methodology (``tools/_measure.py``): a uint8 batch of ``RandomState(0)`` is
staged on the device, and iteration i's images are ``(base + i) mod 256``
times 1/255 in float32, derived on the device. A pass runs ``BENCH_ITERS``
batches; each leaves its checksum (sum of the gathered boxes, scores and
valid mask) on the device, and the pass fetches them once after a
synchronize. There is no on-device loop: the pass's host clock includes the
host's launches, which is what a co-located host pays.

Tiers, built through ``make_predictor`` on the model's seeded weights:
``int8`` (K3 and K6 for every quantized conv) and ``int8_chain`` (K4 for
every residual stage besides), calibrated on 8 images of ``RandomState(7)``
with the space-to-depth stem, their fp parts in float32; ``bf16``. The
classic path runs ``yolo_nms`` at K=256 (K1); ``fused`` runs
``ops/detect.detect`` (scores from logits, boxes decoded for the top K, K1).

``vs_baseline`` divides by 2,000 img/s, the JAX bench's divisor: an assumed
reference point for YOLOv3-416 batch inference on an H100, not a
measurement.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch

from ..device import resolve_device
from . import _measure as M

REFERENCE_IMAGES_PER_SEC = 2000.0
PASSES = 3
NUM_CANDIDATES = 256


def knobs(env=None) -> dict:
    """The ``BENCH_*`` settings of ``env`` (default ``os.environ``)."""
    env = os.environ if env is None else env
    k = dict(batch=int(env.get("BENCH_BATCH", 128)),
             image_size=int(env.get("BENCH_IMAGE_SIZE", 416)),
             iters=int(env.get("BENCH_ITERS", 32)),
             quantize=env.get("BENCH_QUANTIZE", "int8"),
             path=env.get("BENCH_PATH", "classic"),
             model=env.get("BENCH_MODEL", "yolov3"))
    if k["quantize"] not in ("int8", "int8_chain", "bf16"):
        raise ValueError(f"BENCH_QUANTIZE must be int8, int8_chain or bf16, got {k['quantize']!r}")
    if k["path"] not in ("classic", "fused"):
        raise ValueError(f"BENCH_PATH must be classic or fused, got {k['path']!r}")
    return k


def pipeline(spec, params, anchors, nclasses: int, images, path: str = "classic"):
    """The benchmarked predict on ``images`` (already in the tier's dtype) →
    ``(detections, nms)``: detections ``(boxes, classes, scores, valid)``, each
    (B, 100), and for the classic path the ``yolo_nms`` tuple (None for
    ``fused``). Classic: forward → ``yolo_decode`` → ``yolo_nms`` (K=256, IoU
    0.5, score 0.25) → ``gather_detections``; fused: forward →
    ``ops/detect.detect`` with the same settings."""
    from ..models import apply_model
    from ..ops.decode import yolo_decode
    from ..ops.detect import detect
    from ..ops.nms import gather_detections, yolo_nms

    outs = apply_model(spec, params, {}, images)
    if path == "fused":
        return detect(outs, anchors, nclasses, max_boxes=100, iou_threshold=0.5,
                      score_threshold=0.25, num_candidates=NUM_CANDIDATES,
                      scales=spec.head_scales()), None
    boxes, conf, probs = yolo_decode(outs, anchors, nclasses, spec.head_scales())
    nms = yolo_nms(boxes, conf, probs, max_boxes=100, iou_threshold=0.5, score_threshold=0.25,
                   num_candidates=NUM_CANDIDATES)
    return gather_detections(*nms), nms


def run_pass(module, params, base_u8, iters: int, path: str):
    """One timed pass: ``iters`` batches derived from ``base_u8``, their
    checksums stacked on the device and fetched once → (seconds, the
    per-iteration checksums as floats)."""

    def work():
        sums = []
        for i in range(iters):
            images = M.tier_inputs(module, M.derived_images(base_u8, i))
            (boxes, _, scores, valid), _ = pipeline(module.spec, params, module.anchors,
                                                    module.nclasses, images, path)
            sums.append(M.detections_checksum(boxes, scores, valid))
        return torch.stack(sums)

    seconds, sums = M.host_seconds(work, base_u8.device)
    return seconds, sums.cpu().tolist()


def main(argv=None, env=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.bench",
                                 description="BENCH_* environment knobs; see the module doc")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    k = knobs(env)
    dev = resolve_device(args.device)
    module = M.build_tier(f"config/models/{k['model']}/model.yaml", 80, k["quantize"],
                          k["image_size"], dev)
    params = module.tree("params")
    base_u8 = M.staged_uint8(k["batch"], k["image_size"], dev)
    with torch.inference_mode():
        run_pass(module, params, base_u8, k["iters"], k["path"])  # warm-up, plans, checks
        best, checksums = math.inf, None
        for _ in range(PASSES):
            seconds, sums = run_pass(module, params, base_u8, k["iters"], k["path"])
            if not all(math.isfinite(s) for s in sums):
                raise AssertionError(f"bench: non-finite checksum {sums}")
            if seconds < best:
                best, checksums = seconds, sums
    images_per_sec = k["batch"] * k["iters"] / best
    result = {
        "metric": f"{k['model']}_{k['image_size']}_batch_inference_images_per_sec_per_chip",
        "value": round(images_per_sec, 2),
        "unit": "images/sec",
        "vs_baseline": round(images_per_sec / REFERENCE_IMAGES_PER_SEC, 4),
        "device": M.device_record(dev),
    }
    print(json.dumps(result), flush=True)
    return dict(result, quantize=k["quantize"], path=k["path"], batch=k["batch"],
                iters=k["iters"], pass_seconds=best, checksum=sum(checksums))


if __name__ == "__main__":
    main()
