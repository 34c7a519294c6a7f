"""B=1 serving latency: the whole predict (forward + ``ops/detect.detect``)
chained ``--iters`` times, each input derived from the previous predict's
output, so the chain is serialized by its data.

Counterpart of the JAX package's ``tools/latency_bench.py``, with its flags
plus ``--device``:

    python -m yolov3_tpu_torch.tools.latency_bench [--iters 200] [--reps 5]
        [--quantize "" | int8] [--num_candidates 128] [--device cpu]

Iteration i+1's image is ``img * (1 + 1e-6 * tanh(s_i))``, s_i the sum of
iteration i's boxes, scores and valid mask. Two numbers, each under its own
name:

  * **host-clock ms per predict**, the p50 over ``--reps`` runs of the chain,
    each run's host time (one synchronize at its end) over ``--iters``. The
    host queues every launch as it goes, so this is what a co-located client
    waits for a predict, host launches included;
  * **device-busy µs per predict**, the sum of the kernels' device time in
    one chain of ``min(--iters, 20)`` predicts from ``torch.profiler``
    (``ops/cuda/kernel_times.profile_window``) over its length: the card's
    share. Not measured on the CPU.

``--quantize int8`` is the chain tier (``int8_chain``: K3, K4, K6; JAX's
``out_absmax``), calibrated on 2 images of ``RandomState(7)``, its fp parts
in float32 as ``make_predictor`` builds it; ``""`` is bf16. NMS runs K1 at
``--num_candidates``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from . import _measure as M

PROFILED_PREDICTS = 20


def one_predict(spec, params, anchors, nclasses: int, image, num_candidates: int):
    """One B=1 predict on ``image`` (in the tier's dtype) → its scalar checksum
    on the device (boxes + scores + valid of ``detect``, IoU 0.5, score 0.25)."""
    from ..models import apply_model
    from ..ops.detect import detect

    outs = apply_model(spec, params, {}, image)
    boxes, _, scores, valid = detect(outs, anchors, nclasses, max_boxes=100, iou_threshold=0.5,
                                     score_threshold=0.25, num_candidates=num_candidates,
                                     scales=spec.head_scales())
    return M.detections_checksum(boxes, scores, valid)


def chained(predict, image0, iters: int):
    """``iters`` predicts, each on ``img * (1 + 1e-6 * tanh(s))`` of the one
    before (``predict(img)`` → s) → the sum of the checksums, on the device."""
    img, acc = image0, torch.zeros((), dtype=torch.float32, device=image0.device)
    for _ in range(iters):
        s = predict(img)
        img = img * (1.0 + 1e-6 * torch.tanh(s))
        acc = acc + s
    return acc


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.latency_bench")
    ap.add_argument("--model_config_file", default="config/models/yolov3/model.yaml")
    ap.add_argument("--nclasses", type=int, default=80)
    ap.add_argument("--image_size", type=int, default=416)
    ap.add_argument("--iters", type=int, default=200, help="chained predicts per measurement")
    ap.add_argument("--reps", type=int, default=5, help="measurements (p50 over these)")
    ap.add_argument("--quantize", default="", choices=["", "int8"])
    ap.add_argument("--num_candidates", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    module = M.build_tier(args.model_config_file, args.nclasses,
                          "int8_chain" if args.quantize == "int8" else "bf16", args.image_size,
                          dev, calibration_images=2)
    params = module.tree("params")
    s = args.image_size
    image0 = torch.from_numpy(
        np.random.RandomState(0).rand(1, s, s, 3).astype(np.float32)).to(dev)

    def predict(img):  # the chain's image stays float32; the tier's cast is per predict
        return one_predict(module.spec, params, module.anchors, module.nclasses,
                           M.tier_inputs(module, img), args.num_candidates)

    with torch.inference_mode():
        warm_s, acc = M.host_seconds(lambda: chained(predict, image0, args.iters), dev)
        times = []
        for _ in range(args.reps):
            seconds, acc = M.host_seconds(lambda: chained(predict, image0, args.iters), dev)
            acc = float(acc)
            if not np.isfinite(acc):
                raise AssertionError(f"latency_bench: non-finite accumulator {acc}")
            times.append(seconds / args.iters * 1e3)
        profiled = min(args.iters, PROFILED_PREDICTS)
        busy_us = None
        if dev.type == "cuda":
            from ..ops.cuda import kernel_times

            records = kernel_times.profile_window(lambda: chained(predict, image0, profiled))[2]
            if not records:
                raise RuntimeError("latency_bench: the profiler trace holds no device record")
            busy_us = sum(us for _, _, us in records) / profiled
    times.sort()
    p50 = times[len(times) // 2]
    tier = "int8_chain" if args.quantize else "bf16"
    device = M.device_record(dev)
    print(f"p50 host-clock time per B=1 predict ({tier}, {s}x{s}, K={args.num_candidates}): "
          f"{p50:.3f} ms  (per-rep ms over {args.reps} reps of {args.iters} chained: "
          f"{', '.join(f'{t:.3f}' for t in times)}); device-busy per predict: "
          + ("not measured" if busy_us is None else f"{busy_us:.1f} us")
          + f"; device: {M.device_text(device)}", flush=True)
    return dict(tier=tier, image_size=s, num_candidates=args.num_candidates, iters=args.iters,
                reps=args.reps, p50_host_ms=p50, host_ms=times, device_busy_us=busy_us,
                first_run_s=warm_s, accumulator=acc, device=device)


if __name__ == "__main__":
    main()
