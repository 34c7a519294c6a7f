"""Stage-split inference profiler: the bf16 predictor's forward, +decode,
+NMS (the full pipeline) and the fused detect path, each timed alone on one
device.

Counterpart of the JAX package's ``tools/profile_inference.py``, with its
flags plus ``--device``:

    python -m yolov3_tpu_torch.tools.profile_inference [--batch 128]
        [--image_size 416] [--iters 8] [--passes 2] [--num_candidates 256]
        [--device cpu]

The inputs are ``--iters`` batches ``x * (1 + 1e-4 * i)`` of one float32
batch of ``RandomState(0)``, precomputed on the device. Each stage runs them
all once to warm up, then ``--passes`` times; a pass leaves one checksum a
batch on the device and fetches their sum once after a synchronize, and the
best pass is reported in ms per batch and img/s (host clock: the host's
launches included). The NMS stages run K1 at ``--num_candidates``.

Then the model's conv tails by activation (the spec's count, what every
forward runs), e.g. ``activation tails a forward: mish 72, leaky 35,
linear 3`` for YOLOv4, and on the card the device ms of one forward's
kernels whose symbol contains ``mish`` (K8's ``bias_act_mish_kernel``, the
bias add and Mish of a folded conv in one pass), by a profiler window
(``ops/cuda/kernel_times.profile_window``).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..device import resolve_device
from . import _measure as M

STAGES = ("forward", "+decode", "+nms (full pipeline)", "fused-detect")
ACTIVATIONS = ("mish", "leaky", "linear")


def mish_device_ms(spec, params, images):
    """Device ms of one forward's kernels whose symbol contains ``mish``;
    None off the card."""
    if images.device.type != "cuda":
        return None
    from ..models import apply_model
    from ..ops.cuda.kernel_times import profile_window

    def forward():
        with torch.inference_mode():
            apply_model(spec, params, {}, images)

    _, _, records = profile_window(forward)
    return sum(us for _, name, us in records if "mish" in name.lower()) / 1e3


def stage_checksum(stage: str, spec, params, anchors, nclasses: int, images,
                   num_candidates: int):
    """One stage on ``images`` (bf16) → its scalar checksum on the device:
    ``forward`` sums the heads, ``+decode`` the decoded boxes, confidences and
    class probabilities, ``+nms (full pipeline)`` the gathered boxes, scores
    and valid mask of ``yolo_nms`` (IoU 0.5, score 0.25), ``fused-detect``
    those of ``ops/detect.detect``."""
    from ..models import apply_model
    from ..ops.decode import yolo_decode
    from ..ops.detect import detect
    from ..ops.nms import gather_detections, yolo_nms

    outs = apply_model(spec, params, {}, images)
    if stage == "forward":
        return sum(o.float().sum() for o in outs)
    if stage == "fused-detect":
        boxes, _, scores, valid = detect(outs, anchors, nclasses, num_candidates=num_candidates,
                                         scales=spec.head_scales())
        return M.detections_checksum(boxes, scores, valid)
    boxes, conf, probs = yolo_decode(outs, anchors, nclasses, spec.head_scales())
    if stage == "+decode":
        return boxes.sum() + conf.sum() + probs.sum()
    nms = yolo_nms(boxes, conf, probs, max_boxes=100, iou_threshold=0.5, score_threshold=0.25,
                   num_candidates=num_candidates)
    det_boxes, _, det_scores, valid = gather_detections(*nms)
    return M.detections_checksum(det_boxes, det_scores, valid)


def perturbed_inputs(base, iters: int):
    """``base * (1 + 1e-4 * i)`` for i < ``iters``, the factor computed in
    float32 as the JAX tool's traced scalar."""
    return [base * torch.tensor(np.float32(1.0) + np.float32(1e-4) * np.float32(i),
                                device=base.device) for i in range(iters)]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.profile_inference")
    ap.add_argument("--model_config_file", default="config/models/yolov3/model.yaml")
    ap.add_argument("--nclasses", type=int, default=80)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image_size", type=int, default=416)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--num_candidates", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    module = M.build_tier(args.model_config_file, args.nclasses, "bf16", args.image_size, dev)
    params = module.tree("params")
    b, s = args.batch, args.image_size
    base = torch.from_numpy(np.random.RandomState(0).rand(b, s, s, 3).astype(np.float32)).to(dev)
    xs = [M.tier_inputs(module, x) for x in perturbed_inputs(base, args.iters)]
    del base
    M.sync(dev)
    device = M.device_record(dev)
    print(f"device: {M.device_text(device)}, batch {b} @ {s}", flush=True)
    rows = {}
    with torch.inference_mode():
        for stage in STAGES:
            def run(stage=stage):
                return torch.stack([stage_checksum(stage, module.spec, params, module.anchors,
                                                   module.nclasses, x, args.num_candidates)
                                    for x in xs]).sum()

            M.host_seconds(run, dev)  # warm-up
            best, checksum = math.inf, None
            for _ in range(args.passes):
                t0 = time.perf_counter()
                total = float(run())
                seconds = time.perf_counter() - t0
                if not math.isfinite(total):
                    raise AssertionError(f"profile_inference: {stage}: non-finite {total}")
                if seconds < best:
                    best, checksum = seconds, total
            rows[stage] = dict(ms_per_batch=best / args.iters * 1e3,
                               images_per_sec=b * args.iters / best, checksum=checksum)
            print(f"  {stage:22s}: {best / args.iters * 1000:7.2f} ms/batch  "
                  f"{b * args.iters / best:7.0f} img/s", flush=True)
    tails = {a: module.spec.activation_counts[a] for a in ACTIVATIONS}
    mish_ms = mish_device_ms(module.spec, params, xs[0])
    print("activation tails a forward: " + ", ".join(f"{a} {n}" for a, n in tails.items())
          + "; mish kernels: " + ("not measured" if mish_ms is None
                                  else f"{mish_ms:.3f} device ms a forward"), flush=True)
    return dict(batch=b, image_size=s, iters=args.iters, stages=rows, device=device,
                activation_tails=tails, mish_device_ms=mish_ms)


if __name__ == "__main__":
    main()
