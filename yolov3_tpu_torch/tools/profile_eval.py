"""Evaluation-sweep profiler: the batched evaluation pipeline on one device —
forward + decode + NMS at each score threshold of the reference sweep
(``config/evaluate_config.yaml``: 0.004 … 0.9), YOLOv3 at 608².

Counterpart of the JAX package's ``tools/profile_eval.py``, with its flags
plus ``--device``:

    python -m yolov3_tpu_torch.tools.profile_eval [--batch 32] [--image_size 608]
        [--iters 8] [--quantize bf16|int8] [--thresholds 0.004,0.1,0.2,0.5,0.9]
        [--device cpu]

Two top-K buckets, as in the JAX tool: K=512, the serving bucket (the
(B, K, K) IoU matrix and K1), and K = N, every candidate (22,743 at 608²),
the exact NMS the reference's 0.004 entry needs with untrained weights (K2's
round sweep on the unsorted boxes). Methodology of ``bench.py``: a uint8
batch of ``RandomState(0)`` staged on the device, iteration i's images
``(base + i) mod 256`` times 1/255; a pass of ``--iters`` batches, best of
3, one fetch of the checksums after a synchronize. The checksum holds the
selected indices and the counts of every threshold: the boxes and scores
pass through NMS unchanged, so without the indices it would not depend on
the selection. ``--quantize int8`` is the int8 tier with the space-to-depth
stem, calibrated on 4 images of ``RandomState(7)`` (fp parts in float32).
Prints one JSON line a bucket.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ..device import resolve_device
from . import _measure as M


def sweep_checksum(spec, params, anchors, nclasses: int, images, thresholds, k: int):
    """One batch through the sweep → the sum over ``thresholds`` of the
    selected indices and the counts of ``yolo_nms`` at top-K ``k`` (IoU 0.5,
    at most 100 boxes), a scalar on the device."""
    from ..models import apply_model
    from ..ops.decode import yolo_decode
    from ..ops.nms import yolo_nms

    outs = apply_model(spec, params, {}, images)
    boxes, conf, probs = yolo_decode(outs, anchors, nclasses, spec.head_scales())
    total = torch.zeros((), dtype=torch.float32, device=images.device)
    for thr in thresholds:
        out = yolo_nms(boxes, conf, probs, max_boxes=100, iou_threshold=0.5,
                       score_threshold=float(thr), num_candidates=k)
        total = total + out[3].float().sum() + out[4].float().sum()
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.profile_eval")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image_size", type=int, default=608)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--quantize", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--thresholds", default="0.004,0.1,0.2,0.5,0.9")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    module = M.build_tier("config/models/yolov3/model.yaml", 80, args.quantize, args.image_size,
                          dev, calibration_images=4)
    params = module.tree("params")
    b, s = args.batch, args.image_size
    thresholds = [float(t) for t in args.thresholds.split(",")]
    n_anchors = sum(3 * g * g for g in (s // 32, s // 16, s // 8))
    base_u8 = M.staged_uint8(b, s, dev)
    device = M.device_record(dev)
    results = {}
    with torch.inference_mode():
        for label, k in (("K=512", 512), (f"K=N({n_anchors})", n_anchors)):
            def run(k=k):
                return torch.stack([
                    sweep_checksum(module.spec, params, module.anchors, module.nclasses,
                                   M.tier_inputs(module, M.derived_images(base_u8, i)),
                                   thresholds, k)
                    for i in range(args.iters)]).sum()

            M.host_seconds(run, dev)  # warm-up
            best = math.inf
            for _ in range(3):
                seconds, chk = M.host_seconds(run, dev)
                chk = float(chk)
                if not math.isfinite(chk):
                    raise AssertionError(f"profile_eval: {label}: non-finite checksum {chk}")
                best = min(best, seconds)
            results[label] = {"ms_per_batch_full_sweep": round(best / args.iters * 1e3, 2),
                              "images_per_sec_full_sweep": round(b * args.iters / best, 1)}
            line = {"eval_sweep": label, "batch": b, "image_size": s, "thresholds": thresholds,
                    "quantize": args.quantize, **results[label], "device": device}
            print(json.dumps(line), flush=True)
            results[label] = dict(results[label], k=k, checksum=chk)
    return dict(results=results, device=device)


if __name__ == "__main__":
    main()
