"""Batched inference through the serving predictor, closed loop, one batch ahead.

Set-up: the seeded weights and the staged uint8 pool of ``POOL_BATCHES``
batches (``traffic.py``), for ``int8_chain`` ``CALIBRATION_IMAGES`` seeded
calibration images, then ``make_predictor`` (BatchNorm folded, and for
``int8_chain`` calibrated, quantized, the space-to-depth stem and the fused
residual stages packed), and ``WARMUP_BATCHES`` batches through the same
loop: every shape the window uses is built and planned before it opens.

A batch is: its images derived on the device from the pool, ``predict``
(forward → ``yolo_decode`` → ``yolo_nms`` at K = 512), the port's
``gather_detections`` of the selected boxes, classes and scores, and their
copy to the host. Batch i + 1 is submitted before batch i is read back.
The window opens at the first timed submit and closes when the last batch
submitted before ``--seconds`` ran out is on the host; a batch's latency
runs from its ``predict`` call to its detections on the host. A traced run
then profiles ``TRACE_BATCHES`` more.

Kept for the check (``ctx.evidence``): a reservoir sample, drawn from the
seed, of ``SAMPLE_BATCHES`` window batches: the predictor's full outputs and
the detections read back.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import traffic
from ..judge import anchors, judge_infer
from ..reference.graph import load_graph
from ..weights import make_weights
from . import span

POOL_BATCHES = 8
CALIBRATION_IMAGES = 8
WARMUP_BATCHES = 3
SAMPLE_BATCHES = 1
TRACE_BATCHES = 12


def _tier(cell):
    if cell["tier"] == "int8_chain":
        return {"quantize": "int8_chain"}
    if cell["tier"] == "bf16":
        return {"compute_dtype": torch.bfloat16}
    raise ValueError(f"unknown inference tier {cell['tier']!r}")


def run(ctx):
    cfg, cell, dev, seed = ctx.config, ctx.cell, ctx.device, ctx.seed
    size, batch, nclasses = int(cfg["image_size"]), int(cell["batch"]), int(cfg["classes"])
    graph = load_graph(ctx.path(cfg["model"]), nclasses)
    params, state = make_weights(graph, nclasses, seed, size, dev)
    ctx.mark("weights")
    pool = traffic.image_pool(seed, POOL_BATCHES, batch, size, dev)
    calib = (traffic.calibration_images(seed, CALIBRATION_IMAGES, size, dev)
             if cell["tier"] == "int8_chain" else None)
    table = anchors(cfg)
    nms = cell["nms"]

    ctx.mark("inputs")
    from yolov3_tpu_torch.apps.inference_app import make_predictor
    from yolov3_tpu_torch.models import parse_model_config
    from yolov3_tpu_torch.ops.nms import gather_detections

    spec = parse_model_config(ctx.path(cfg["model"]), nclasses)
    predict = make_predictor(
        spec, params, state, table, nclasses, nms["max_boxes"], nms["iou_threshold"],
        nms["score_threshold"], calibration_batches=None if calib is None else [calib],
        image_size=size, device=dev, **_tier(cell))

    ctx.mark("predictor")

    def submit(i):
        with span("input"):
            images = traffic.derived(pool, i)
        t0 = time.perf_counter()
        with span("predict"):
            out = predict(images)
        t1 = time.perf_counter()
        with span("gather"):
            det = gather_detections(*out)
        return out, det, t0, t1 - t0

    def readback(det):
        with span("readback"):
            return tuple(t.cpu() for t in det)

    def loop(first, n=None, seconds=None, keep=None):
        """Batches from ``first``, one ahead, until ``n`` are done or
        ``seconds`` have passed since the first submit → (batches, start,
        end, latencies, predict host seconds)."""
        lat, host = [], []
        i, cur = first, submit(first)
        start = cur[2]
        while True:
            go = (i + 1 - first < n) if n is not None else (time.perf_counter() - start < seconds)
            nxt = submit(i + 1) if go else None
            dets = readback(cur[1])
            end = time.perf_counter()
            lat.append(end - cur[2])
            host.append(cur[3])
            if keep is not None:
                keep(i - first, i, cur[0], dets)
            if nxt is None:
                return i + 1 - first, start, end, lat, host
            i, cur = i + 1, nxt

    warm = WARMUP_BATCHES
    loop(0, n=warm)
    ctx.sync()
    ctx.setup_done()

    k = SAMPLE_BATCHES
    rng = np.random.default_rng([seed, 5])
    sample = {}

    def keep(j, i, out, dets):
        slot = j if j < k else int(rng.integers(0, j + 1))
        if slot < k:
            sample[slot] = (i, out, dets)

    n, start, end, lat, host = loop(warm, seconds=ctx.seconds, keep=keep)
    ctx.window = {"seconds": end - start, "images": n * batch, "batches": n}
    ctx.spans = {"predict": host}
    ctx.e2e = {"infer_images_per_s": n * batch / (end - start),
               "infer_batch_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95))}
    ctx.attempted, ctx.failed = n * batch, 0

    if ctx.trace:
        ctx.profile(lambda: loop(warm + n, n=TRACE_BATCHES), TRACE_BATCHES)

    ctx.read_memory()
    del predict
    ctx.free()
    ctx.evidence = {"graph": graph, "params": params, "state": state, "calib": calib,
                    "inputs": lambda i: traffic.derived(pool, i),
                    "samples": [sample[s] for s in sorted(sample)]}


def check(ctx, evidence):
    """The check's numbers (``judge.judge_infer``) of ``evidence``'s samples."""
    e = evidence
    return judge_infer(e["graph"], e["params"], e["state"], ctx.config, ctx.cell, e["calib"],
                       e["inputs"], e["samples"], ctx.device)
