#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (yolov3_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card identity (nvidia-smi name + power limit) and the fp32 settings
     (no TF32 in cuDNN convolutions, matmul precision "highest");
  2. build the hand-written CUDA kernels from the checkout's sources;
  3. K1 (NMS suppression sweep) against its plain PyTorch version on the
     card, B=16 at K=512 (the serving bucket) and K=4096 (the matrix-sweep
     bound): identical keep masks, times, bound;
  4. K2 (full round sweep) against its plain version, B=16 at N=10,647
     (416²) and N=22,743 (608²), max_boxes 100, score threshold 0.004:
     identical indices and counts, times, bound;
  5. serve YOLOv3-416 (Darknet-53, 3 heads, 80 COCO classes, seeded
     weights) through build_serving_predictor + DetectionApp, buckets
     [1, 4, 16], fp32 and bf16, encoded images from 48 closed-loop client
     threads (3 s warm-up, then a 20 s measured window per tier), then
     yolo_nms_exact at threshold 0.004 on one served batch's heads;
     both kernels' launch counters must rise over this run;
  6. YOLOv3-tiny with the in-repo trained checkpoint on the 32 shapes_toy
     images: the port on the card (fp32, no TF32) against the port on the
     CPU (decoded heads, NMS on the same inputs, served detections; an
     image that differs must show the near-tie that makes it differ).
Output: a JSON line of every kernel, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Needs no network and one card; imports nothing of JAX.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM fp32, outside the tensor cores
IOU_THR = 0.5
# serving: closed-loop clients, a warm-up then a measured window per tier
SERVE_CLIENTS = 48
SERVE_WARM_S = 3.0
SERVE_WINDOW_S = 20.0
# an image may differ end to end between card and CPU only where a
# decision of greedy NMS sits within this margin of flipping
NEAR_TIE = 1e-5


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds per call over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def seeded_boxes(rng, b, n, min_wh=0.02, max_wh=0.3):
    xy = rng.rand(b, n, 2) * 0.8
    wh = rng.rand(b, n, 2) * (max_wh - min_wh) + min_wh
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def phase_k1(nms, nms_kernel):
    """K1 at the serving bucket and at the matrix-sweep bound."""
    results = []
    for k in (512, 4096):
        rng = np.random.RandomState(k)
        boxes = torch.from_numpy(seeded_boxes(rng, 16, k, 0.01, 0.12)).cuda()
        mat = nms._pairwise_iou(boxes) > IOU_THR
        valid = torch.from_numpy(rng.rand(16, k) < 0.6).cuda()
        if float(valid.float().mean()) < 0.5:
            raise AssertionError("K1 smoke input needs at least half the candidates valid")
        keep = nms_kernel.suppression_sweep(mat, valid)
        torch.cuda.synchronize()
        ref = nms_kernel.suppression_sweep_ref(mat, valid)
        equal = torch.equal(keep, ref)
        err = int((keep.int() - ref.int()).abs().max())
        kept = keep.sum(dim=1)
        ms = cuda_ms(lambda: nms_kernel.suppression_sweep(mat, valid), 50)
        plain_ms = cuda_ms(lambda: nms_kernel.suppression_sweep_ref(mat, valid), 2)
        # bytes this run needs: of each kept box's row only the entries
        # j > i (the rest are never read), the valid mask in, the keep mask out
        later = (k - 1 - torch.arange(k, device=keep.device))[None, :]
        need = int((later * keep).sum()) + 2 * 16 * k
        bound_ms = need / HBM_BYTES_PER_S * 1e3
        row = dict(B=16, K=k, equal=equal, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bytes=need, dependent_steps=k,
                   kept_max=int(kept.max()), kept_mean=float(kept.float().mean()))
        log(f"K1 nms_sweep {json.dumps(row)}")
        if not equal:
            raise AssertionError(f"K1 differs from its plain version at K={k}")
        results.append(row)
    return results


def k2_live_visits(round_sweep, boxes, scores, sel, nv, score_thr):
    """Sum over images and rounds that found a box of the boxes still live
    at the round's start: the work this run's data needs, replayed from the
    kernel's own selections."""
    rows = torch.arange(boxes.shape[0], device=boxes.device)
    live = scores > score_thr
    visits = 0
    for r in range(sel.shape[1]):
        active = r < nv
        visits += int((live.sum(1) * active).sum())
        j = sel[:, r].long()
        kill = round_sweep._iou_one_vs_all(boxes[rows, j], boxes) > IOU_THR
        kill[rows, j] = True
        live &= ~(kill & active[:, None])
    return visits


def phase_k2(round_sweep):
    results = []
    for n in (10647, 22743):
        rng = np.random.RandomState(n)
        boxes = torch.from_numpy(seeded_boxes(rng, 16, n)).cuda()
        scores = torch.from_numpy(rng.rand(16, n).astype(np.float32)).cuda()
        sel, nv = round_sweep.round_sweep(boxes, scores, IOU_THR, 0.004, 100)
        torch.cuda.synchronize()
        rsel, rnv = round_sweep.round_sweep_ref(boxes, scores, IOU_THR, 0.004, 100)
        equal = torch.equal(sel, rsel) and torch.equal(nv, rnv)
        err = int(max((sel - rsel).abs().max(), (nv - rnv).abs().max()))
        ms = cuda_ms(lambda: round_sweep.round_sweep(boxes, scores, IOU_THR, 0.004, 100), 20)
        plain_ms = cuda_ms(lambda: round_sweep.round_sweep_ref(boxes, scores, IOU_THR,
                                                               0.004, 100), 2)
        need = 16 * n * (16 + 4) + 16 * 100 * 4 + 16 * 4
        # per box still live in a round that found one: 1 argmax compare +
        # 17 IoU ops (dead and below-threshold boxes need neither)
        ops = k2_live_visits(round_sweep, boxes, scores, sel, nv, 0.004) * 18
        bound_ms = max(need / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        bound_by = "bytes" if need / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S else "operations"
        row = dict(B=16, N=n, max_boxes=100, equal=equal, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=need,
                   ops=ops, rounds=int(nv.max()), nv_min=int(nv.min()))
        log(f"K2 round_sweep {json.dumps(row)}")
        if not equal:
            raise AssertionError(f"K2 differs from its plain version at N={n}")
        if int(nv.min()) != 100:
            raise AssertionError("K2 smoke input should fill all 100 rounds")
        results.append(row)
    return results


def encoded_requests():
    files = sorted(glob.glob(os.path.join(ROOT, "datasets/shapes_toy/coco/images/*.jpg")))
    files.append(os.path.join(ROOT, "datasets/coco2012/images/girl.png"))
    if len(files) < 9:
        raise FileNotFoundError("smoke images missing from the checkout")
    return [open(f, "rb").read() for f in files]


def serve_tier(tier, inference_app, serve_app, bodies):
    model_dir = os.path.join(ROOT, "config/models/yolov3")
    t0 = time.monotonic()
    predictor, names, _ = inference_app.build_serving_predictor(
        os.path.join(model_dir, "model.yaml"),
        os.path.join(ROOT, "datasets/coco2012/coco.names"),
        os.path.join(ROOT, "datasets/coco2012/anchors.txt"),
        None, 416, yolo_max_boxes=100, nms_iou_threshold=0.5, nms_score_threshold=0.1,
        compute_precision=tier, seed=0)
    if len(names) != 80:
        raise AssertionError(f"expected the 80 COCO classes, got {len(names)}")
    app = serve_app.DetectionApp(predictor, names, 416, batch_buckets=(1, 4, 16),
                                 batch_timeout_ms=5)
    try:
        app.batcher.warmup((416, 416))
        torch.cuda.synchronize()
        setup_s = time.monotonic() - t0
        # closed loop: each client sends its next request when the last one
        # returns; enough clients to keep the 16 bucket fillable
        latencies, finished, errors, detections = [], [], [], []
        t1 = time.monotonic()
        t_warm, t_end = t1 + SERVE_WARM_S, t1 + SERVE_WARM_S + SERVE_WINDOW_S

        def client(t):
            i = t
            while time.monotonic() < t_end:
                start = time.monotonic()
                try:
                    r = app.detect(bodies[i % len(bodies)])
                except Exception as exc:  # reported below, fails the phase
                    errors.append(repr(exc))
                    return
                end = time.monotonic()
                for d in r["detections"]:
                    if not all(np.isfinite(d["box_normalized"])) or not 0 <= d["score"] <= 1:
                        errors.append(f"malformed detection {d}")
                if t_warm <= end <= t_end:
                    finished.append(end)
                    detections.append(len(r["detections"]))
                    if start >= t_warm:
                        latencies.append((end - start) * 1e3)
                i += SERVE_CLIENTS

        threads = [threading.Thread(target=client, args=(t,)) for t in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(max(0.0, t_warm - time.monotonic()))
        hist0 = app.stats.snapshot()["batch_histogram"]
        for t in threads:
            t.join(600)
        if errors or any(t.is_alive() for t in threads) or len(latencies) < 100:
            raise AssertionError(f"{tier}: {len(latencies)} requests in the window, "
                                 f"failures {errors[:3]}")
        hist = {k: v - hist0.get(k, 0)
                for k, v in app.stats.snapshot()["batch_histogram"].items()}
        p50, p99 = np.percentile(latencies, [50, 99])
        row = dict(tier=tier, client_threads=SERVE_CLIENTS, window_s=SERVE_WINDOW_S,
                   setup_s=setup_s, requests_in_window=len(finished),
                   images_per_s=len(finished) / SERVE_WINDOW_S,
                   latency_samples=len(latencies), p50_ms=float(p50), p99_ms=float(p99),
                   batch_histogram={k: v for k, v in hist.items() if v},
                   detections=sum(detections))
        log(f"serve {json.dumps(row)}")
    finally:
        app.shutdown()
    return predictor, row


def phase_serve(inference_app, serve_app, models, decode, nms_mod, nms_kernel, round_sweep):
    bodies = encoded_requests()
    nms_kernel.suppression_sweep.launches = 0
    round_sweep.round_sweep.launches = 0
    rows = []
    for tier in ("fp32", "bf16"):
        _, row = serve_tier(tier, inference_app, serve_app, bodies)
        rows.append(row)
    k1_serving = nms_kernel.suppression_sweep.launches

    # the evaluation's exact NMS (yolo_nms_exact) on one served batch at the
    # eval sweep's lowest threshold: the first bucket is 64 candidates, so
    # with 100 boxes asked the truncation provably matters and it must
    # escalate — on the card straight to K = N, the round-sweep kernel
    from yolov3_tpu_torch.config import get_anchors, read_class_names
    from yolov3_tpu_torch.data.image import decode_image, resize_bilinear

    names = read_class_names(os.path.join(ROOT, "datasets/coco2012/coco.names"))
    spec = models.parse_model_config(os.path.join(ROOT, "config/models/yolov3/model.yaml"),
                                     len(names))
    params, state = models.init_model(spec, torch.Generator().manual_seed(0))
    folded = models.fold_batch_norm(params, state)
    anchors = get_anchors(os.path.join(ROOT, "datasets/coco2012/anchors.txt"))
    batch = np.stack([resize_bilinear(decode_image(b) / 255.0, 416, 416) for b in bodies[:16]])
    from yolov3_tpu_torch.models.network import to_device

    cuda_params = to_device(folded, "cuda")
    with torch.inference_mode():
        heads = models.apply_model(spec, cuda_params, {}, torch.from_numpy(batch).float().cuda())
        boxes, conf, probs = decode.yolo_decode(heads, anchors, len(names))
        out = nms_mod.yolo_nms_exact(boxes, conf, probs, max_boxes=100, iou_threshold=0.5,
                                     score_threshold=0.004, num_candidates=64)
        torch.cuda.synchronize()
    sel, nv = out[3], out[4]
    if tuple(sel.shape) != (16, 100) or not bool((nv == 100).all()):
        raise AssertionError(f"yolo_nms_exact: shape {tuple(sel.shape)}, nv {nv.tolist()}")
    launches = {"nms_sweep": nms_kernel.suppression_sweep.launches,
                "round_sweep": round_sweep.round_sweep.launches}
    log(f"main path launches {json.dumps(launches)} (K1 while serving: {k1_serving})")
    if k1_serving == 0 or launches["round_sweep"] == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # the served forward against the port on the CPU, full width, one image
    with torch.inference_mode():
        cpu_heads = models.apply_model(spec, folded, {}, torch.from_numpy(batch[:1]).float())
    head_err = max(float((h[:1].float().cpu() - c).abs().max())
                   for h, c in zip(heads, cpu_heads))
    log(f"YOLOv3-416 fp32 heads, card vs CPU: max abs err {head_err:.3e} "
        f"(shapes {[tuple(h.shape) for h in heads]})")
    if not all(bool(torch.isfinite(h).all()) for h in heads) or head_err > 1e-3:
        raise AssertionError(f"full-width heads disagree with the CPU: {head_err}")

    # where a B=16 batch's time goes: host preprocessing per image (wall
    # clock, one thread) and device ms of each predictor stage (CUDA events)
    t0 = time.perf_counter()
    for b in bodies[:16]:
        resize_bilinear(decode_image(b) / 255.0, 416, 416)
    host_ms = (time.perf_counter() - t0) * 1e3 / 16
    x = torch.from_numpy(batch).float().cuda()
    for tier, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        p, xi = to_device(folded, "cuda", dtype), x.to(dtype)
        with torch.inference_mode():
            fwd = cuda_ms(lambda: models.apply_model(spec, p, {}, xi), 5)
            hs = models.apply_model(spec, p, {}, xi)
            dec = cuda_ms(lambda: decode.yolo_decode(hs, anchors, 80), 5)
            d = decode.yolo_decode(hs, anchors, 80)
            nms_ms = cuda_ms(lambda: nms_mod.yolo_nms(*d, max_boxes=100, iou_threshold=0.5,
                                                      score_threshold=0.1), 5)
        row = dict(tier=tier, batch=16, host_preprocess_ms_per_image=host_ms,
                   forward_ms=fwd, decode_ms=dec, nms_ms=nms_ms)
        log(f"breakdown {json.dumps(row)}")
    return rows, launches


def near_tie_witness(nms_mod, g_boxes, g_scores, c_boxes, c_scores, nms_kw):
    """Why one image's detections differ between the card (g) and the CPU
    (c): every decision of greedy NMS whose outcome differs between the two
    inputs, with its CPU margin. Three kinds: a score on the other side of
    the score threshold; the first valid rank where the stable top-K order
    differs (margin: the CPU score gap of the swapped pair); a pair of valid
    candidates whose IoU > threshold test differs. ``margin`` is the largest
    margin among them, None when nothing flips."""
    score_thr, iou_thr = nms_kw["score_threshold"], nms_kw["iou_threshold"]
    k = min(nms_mod.DEFAULT_NUM_CANDIDATES, c_scores.shape[0])
    margins = []
    thr_flip = (g_scores > score_thr) != (c_scores > score_thr)
    margins += (c_scores[thr_flip] - score_thr).abs().tolist()
    og = torch.argsort(-g_scores, stable=True)[:k]
    oc = torch.argsort(-c_scores, stable=True)[:k]
    valid = c_scores[oc] > score_thr
    swapped = ((og != oc) & (valid | (g_scores[og] > score_thr))).nonzero()
    first_swap = int(swapped[0]) if len(swapped) else None
    if first_swap is not None:
        margins.append(float((c_scores[oc[first_swap]] - c_scores[og[first_swap]]).abs()))
    iou_g = nms_mod._pairwise_iou(g_boxes[oc][None])[0]
    iou_c = nms_mod._pairwise_iou(c_boxes[oc][None])[0]
    iou_flip = ((iou_g > iou_thr) != (iou_c > iou_thr)) & valid[:, None] & valid[None, :]
    margins += (iou_c[iou_flip] - iou_thr).abs().tolist()
    return dict(score_threshold_flips=int(thr_flip.sum()), first_swapped_rank=first_swap,
                iou_flips=int(iou_flip.sum()) // 2, margin=max(margins) if margins else None)


def phase_trained(inference_app, models, decode, nms_mod):
    """YOLOv3-tiny + the trained checkpoint on the 32 shapes_toy images: the
    card (fp32, no TF32) against the CPU.

    Tolerances: decoded boxes 1e-3 and objectness/class probabilities 1e-4
    (float32 forward, convolutions summed in another order); NMS on the
    SAME decoded tensors index-exact (the kernel against its plain version
    on real detections). End to end, greedy NMS is discontinuous where two
    scores tie or an IoU sits at the threshold, so rounding differences of
    ~1e-7 in the forward can change an image's detections. An image may
    differ only with a witness: a decision of NMS that flips between the
    card's and the CPU's inputs within ``NEAR_TIE`` of its threshold (see
    ``near_tie_witness``). Each image that agrees must agree in classes,
    boxes (1e-3) and scores (1e-4).
    """
    from yolov3_tpu_torch.config import get_anchors, read_class_names
    from yolov3_tpu_torch.data.image import decode_image, resize_bilinear
    from yolov3_tpu_torch.io.resolve import load_weights
    from yolov3_tpu_torch.models.network import to_device

    files = sorted(glob.glob(os.path.join(ROOT, "datasets/shapes_toy/coco/images/*.jpg")))
    images = np.stack([resize_bilinear(decode_image(open(f, "rb").read()) / 255.0, 416, 416)
                       for f in files]).astype(np.float32)
    model = os.path.join(ROOT, "config/models/yolov3_tiny/model.yaml")
    names = os.path.join(ROOT, "datasets/shapes_toy/class.names")
    anchors_file = os.path.join(ROOT, "datasets/shapes_toy/anchors/anchors_tiny.txt")
    ckpt = os.path.join(ROOT, "checkpoints/output/yolov3_train_tiny.tf")
    nc = len(read_class_names(names))
    anchors = get_anchors(anchors_file)
    spec = models.parse_model_config(model, nc)
    params, state = models.init_model(spec, torch.Generator().manual_seed(0))
    folded = models.fold_batch_norm(*load_weights(spec, params, state, ckpt))

    decoded = {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            heads = models.apply_model(spec, to_device(folded, dev), {},
                                       torch.from_numpy(images).to(dev))
            decoded[dev] = decode.yolo_decode(heads, anchors, nc)
        errs = [float((g.cpu() - c).abs().max()) for g, c in zip(decoded["cuda"],
                                                                 decoded["cpu"])]
        nms_kw = dict(max_boxes=100, iou_threshold=0.5, score_threshold=0.1)
        on_card = [t.cpu() for t in nms_mod.yolo_nms(*decoded["cuda"], **nms_kw)]
        plain = nms_mod.yolo_nms(*(t.cpu() for t in decoded["cuda"]), **nms_kw)
    nms_equal = all(torch.equal(a, b) for a, b in zip(on_card, plain))

    outs = {}
    for dev in ("cuda", "cpu"):
        pred, _, _ = inference_app.build_serving_predictor(
            model, names, anchors_file, ckpt, 416, nms_score_threshold=0.1, device=dev)
        outs[dev] = [t.cpu() for t in pred(images)]
    gb, gc, gs, gsel, gnv = outs["cuda"]
    cb, cc, cs, csel, cnv = outs["cpu"]
    witnesses, box_err, score_err = [], 0.0, 0.0
    for i in range(len(files)):
        gi, ci = gsel[i, : int(gnv[i])].long(), csel[i, : int(cnv[i])].long()
        if int(gnv[i]) != int(cnv[i]) or not torch.equal(gc[i, gi], cc[i, ci]):
            witnesses.append(dict(image=i, detections_card=int(gnv[i]),
                                  detections_cpu=int(cnv[i]),
                                  **near_tie_witness(nms_mod, gb[i], gs[i], cb[i], cs[i],
                                                     nms_kw)))
            continue
        box_err = max(box_err, max_abs(gb[i, gi], cb[i, ci]))
        score_err = max(score_err, max_abs(gs[i, gi], cs[i, ci]))
    row = dict(images=len(files), detections_card=int(gnv.sum()),
               detections_cpu=int(cnv.sum()), images_differing=witnesses,
               decoded_max_abs_err={"boxes": errs[0], "conf": errs[1], "probs": errs[2]},
               nms_same_inputs_equal=nms_equal, box_max_abs_err=box_err,
               score_max_abs_err=score_err)
    log(f"trained tiny card vs CPU {json.dumps(row)}")
    unexplained = [w["image"] for w in witnesses
                   if w["margin"] is None or w["margin"] > NEAR_TIE]
    if (errs[0] > 1e-3 or max(errs[1:]) > 1e-4 or not nms_equal or unexplained
            or box_err > 1e-3 or score_err > 1e-4):
        raise AssertionError(f"trained tiny: card vs CPU beyond tolerance {row}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; this script runs the port on the card",
              file=sys.stderr)
        return 2
    from yolov3_tpu_torch import models
    from yolov3_tpu_torch.apps import inference_app, serve_app
    from yolov3_tpu_torch.ops import decode
    from yolov3_tpu_torch.ops import nms as nms_mod
    from yolov3_tpu_torch.ops.cuda import build, nms_kernel, round_sweep

    # phase 1 — card identity and the fp32 settings
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} matmul precision="
        f"{torch.get_float32_matmul_precision()}")

    # phase 2 — build
    build.build_all()
    log(f"kernels built in {build.build_seconds:.1f}s into {build.BUILD_DIR}")

    k1 = phase_k1(nms_mod, nms_kernel)
    k2 = phase_k2(round_sweep)
    serve_rows, launches = phase_serve(inference_app, serve_app, models, decode, nms_mod,
                                       nms_kernel, round_sweep)
    phase_trained(inference_app, models, decode, nms_mod)

    kernels = [
        dict(name="nms_sweep", route="cuda",
             source="yolov3_tpu_torch/ops/cuda/csrc/nms_sweep.cu",
             replaces="yolov3_tpu/ops/pallas/nms_kernel.py:76",
             launches=launches["nms_sweep"], equal_to_plain=all(r["equal"] for r in k1),
             max_abs_err=max(r["max_abs_err"] for r in k1), ms=k1[0]["ms"],
             kernel_ms=k1[0]["ms"], plain_ms=k1[0]["plain_ms"], bound_ms=k1[0]["bound_ms"],
             bound_by="bytes", library_ms=None, shapes=k1),
        dict(name="round_sweep", route="cuda",
             source="yolov3_tpu_torch/ops/cuda/csrc/round_sweep.cu",
             replaces="yolov3_tpu/ops/pallas/round_sweep.py:110",
             launches=launches["round_sweep"], equal_to_plain=all(r["equal"] for r in k2),
             max_abs_err=max(r["max_abs_err"] for r in k2), ms=k2[0]["ms"],
             kernel_ms=k2[0]["ms"], plain_ms=k2[0]["plain_ms"], bound_ms=k2[0]["bound_ms"],
             bound_by=k2[0]["bound_by"], library_ms=None, shapes=k2),
    ]
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels, "serve": serve_rows, "card": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
