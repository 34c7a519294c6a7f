#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (yolov3_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card identity (nvidia-smi name + power limit), the torch and CUDA
     versions and the fp32 settings (no TF32 in cuDNN convolutions, matmul
     precision "highest"; the port's fp32 entry points pin the same on their
     own, ``device.pin_fp32_ieee``);
  2. build the hand-written CUDA kernels from the checkout's sources;
  3. K1 (NMS suppression sweep) against its plain PyTorch version on the
     card, K=512 (the serving bucket) at B=16, 1 and 4: identical keep
     masks, one device launch a call (profiler), times, device µs of a
     call, bound;
  4. K2 (full round sweep, a thread-block cluster an image) against its
     plain version at N=10,647 (416²) and N=22,743 (608²), B = 16, 1 and 4,
     max_boxes 100, score threshold 0.004: identical indices and counts, the
     cluster plan, times, device µs of a call, bound, and the latency floor
     (100 rounds of the design's cross-block exchange alone);
  5. serve YOLOv3-416 (Darknet-53, 3 heads, 80 COCO classes, seeded
     weights) through build_serving_predictor + DetectionApp, buckets
     [1, 4, 16], fp32 and bf16, encoded images from 48 closed-loop client
     threads (2 s warm-up, then a 5 s measured window per tier), then
     yolo_nms_exact at threshold 0.004 on one served batch's heads;
     both kernels' launch counters must rise over this run; one B=16 call
     of each served predictor with K8's counts set to 0 just before it
     (``k8_forward``): ``conv tails fused 75 of 75 a batch``, 75 launches;
     then the same exact NMS escalating by jumping to K = N against
     doubling, in turns;
  6. YOLOv3-tiny with the in-repo trained checkpoint on the 32 shapes_toy
     images: the port on the card (fp32, no TF32) against the port on the
     CPU (decoded heads, NMS on the same inputs, served detections; an
     image that differs must show the near-tie that makes it differ);
  7. K3 (fused int8 1×1 conv) against its plain version, bit-equal, int8
     and f32 outputs, leaky on and off, at every quantized 1×1 shape of
     YOLOv3-416 at B=16, the 13² head conv at B=1 and 4, and one ragged M;
     for each the plan and the path the launch took (persistent, wgmma or
     mma.sync, read off the profiled kernel's name), times, device µs of one
     launch, TOP/s, bound, and torch._int_mm + a torch epilogue as the
     library yardstick;
  8. K6 (int8 k×k conv) against its plain version, bit-equal, at ten
     YOLOv3-416 shapes: 3×3 stride 1 and 2 at 26², both convs of the
     space-to-depth stem, one 3×3 stride-1 conv per stage at B=16 and the
     head's 13² conv at the serving buckets 1 and 4; for each the path the
     launch took (wgmma or mma.sync, read off the profiled kernel's name),
     tile, grid, times, TOP/s, bound, and a cuDNN TF32 conv of the int8
     values + torch epilogue as the library yardstick;
  9. the int8 tiers at full width: YOLOv3-416 calibrated on the smoke
     images, ``int8`` and ``int8_chain``: the card against the CPU on the
     same quantized params (every quantized layer bit-equal, heads 1e-3),
     device forward ms at B=16, K3/K6 launches per forward, and K3's and
     K6's launches of one forward grouped by shape (count, ms, bound, path)
     from the profiler: no 1×1 conv with Cin % 16 == 0 may run K3's
     mma.sync kernel; K4's launches a forward (one a block of the residual
     stages ``int8_chain`` routes through it: all 23 of Darknet-53; none in
     ``int8``); for ``int8_chain`` the forward with no residual stage and
     with all five through K4 (device and event-loop ms in turns), the
     routed forward's heads bit-equal to the unrouted one's on the card and
     within 1e-3 of the CPU;
 10. K4 (fused int8 residual block): every residual stage of that
     chain-quantized model through K4 chained in halo layout against the
     unfused chain K3 → K6 → add_requant on the same int8 input (bit-equal),
     K4 against its plain version (bit-equal), at B=16, 1 and 4; at B=16
     each stage both ways in turns (event-loop ms and device ms), one K4
     block's device µs, the plan;
 11. serve the ``int8`` tier for a 5 s window as in 5; K3 and K6 must
     launch while serving;
 12. trained YOLOv3-tiny, ``int8_chain``: detections on the card against
     the CPU on the same quantized params (held as in 6), and against the
     fp32 detections (printed);
 13. K5 (BatchNorm statistics, forward and backward) against its plain
     version at B=16 shapes of YOLOv3-416 (C=32 at 416², 64 at 208², 256 at
     52², 512 at 26², 1024 at 13²) and one odd shape, f32 and bf16,
     channels-last and NCHW memory: sums within 1e-5 of Σ|x| and Σx² against
     float64, two launches bit-identical, mean and var bit-equal to the plain
     expression evaluated on the card, dx bit-equal to the plain version, one
     device launch a call each way (profiler); the event-loop time, the
     device time of one call and the host's µs a call, the byte bound, and
     torch.var_mean / torch.batch_norm_stats as the library yardstick; then
     two calls at once on two streams; then K7 (the training BatchNorm tail,
     ``phase_k7``) at every distinct tail of YOLOv3-416 at B=64, bf16,
     channels-last (the train cell's): forward bit-equal to
     ``bn_leaky_plain``, dx to ``bn_leaky_dx_plain``, the (C,) gradients
     within K5's sum tolerance of float64, one launch each way, times and
     bytes bound each way; then K8 (the folded fp conv's bias and
     activation, ``phase_k8``) at every distinct fp tail of the two bf16
     serving cells (YOLOv3-416 and YOLOv4-608, at B=8 and 4, channels-last):
     bit-equal to ``bias_act_plain``, one launch a call, times and bytes
     bound, the host's µs a call through the op and through the plain
     expression;
 14. one training forward and backward of YOLOv3-416 at B=2, seeded weights
     and labels, fp32 without TF32, the card against the CPU: targets
     bit-equal, loss terms 1e-4 relative, new BN state 1e-4, and every
     gradient leaf of both held against a float64 reference (the card at most
     twice as far from it as the CPU; see the phase's docstring); K5 must
     launch 72 times forward and 72 times backward;
 15. the trainer through ``Train``: YOLOv3-416, B=16, shapes_toy TFRecords,
     Adam, EMA, 3 epochs (6 steps) in fp32 and again with
     ``mixed_precision``: finite falling loss, K5 and K7 launches 72 × steps
     each way, the three checkpoint files, a resumed sixth epoch, the serving
     predictor answering from the trained checkpoint; ms per step, img/s,
     peak memory, device launches per step (72 + 72 of them K5's, as many
     K7's) and K5's and K7's shares of a step's device time;
 16. ``evaluate`` of the trained YOLOv3-tiny at 416 over shapes_toy
     ``tfrecords/val`` (16 images, batch 8), the sweep [0.004, 0.1, 0.2,
     0.5, 0.9], on the card and on the CPU: counters equal per threshold or
     a near-tie witness for each image that differs; at 0.004 the escalation
     reaches K = N = 2,535 in one step (K2); K1 and K2 launch; the matcher
     alone card vs CPU bit-equal on the card's detections and on corner
     cases (argmax ties, NaN and inf boxes); mAP@0.5 and img/s;
 17. ``evaluate`` at full width on the card: YOLOv3-416 for 3 classes with
     seeded weights (``save_weights`` under ``build/``), batch 16 over the 32
     ``tfrecords/train`` images, one run of the sweep: per threshold img/s,
     largest K, K1 and K2 launches;
 18. the int8 accuracy gate (``yolov3_tpu_torch.tools.int8_accuracy_gate``)
     on the card, trained tiny at 416 over ``tfrecords/val``: mAP@0.5 of
     bf16 and int8 (and fp32 the gate's way), the verdict (a measurement,
     not a failure), K3 and K6 launch;
 19. batch inference through ``Inference`` on the card (outputs under
     ``build/smoke_infer/``): the trained tiny over ``tfrecords/test`` at 416
     in fp32 and over the shapes_toy images with ``letterbox``, phase 17's
     seeded YOLOv3-416 over ``tfrecords/test`` in ``int8_chain`` (K4
     launches: the tiny has no residual block);
     fp32 and letterbox against the CPU under phase 6's near-tie rule;
     ``ops/detect.detect`` against decode ∘ yolo_nms ∘ gather on the card
     (K1 launches); ``ops/image`` card vs CPU within 1e-5;
 20. the trainer's extras (outputs under ``build/smoke_extras/``): K5 against
     its plain version on its new inputs — the phase view of the
     space-to-depth stem's conv0 output (16, 128, 208, 208) in NCHW and
     channels-last memory, f32 and bf16, and the stride-2 subsample copy of a
     52² activation — with its device µs beside the same statistics without
     the rewrite; one ``Train`` run of YOLOv3-416 at B=16 with every key of
     the slice on (augmentation, qat full, stem_s2d, multi_scale [320, 416]
     every step, device_dataset uint8, bn_stats_subsample 2, remat conv,
     tensorboard, profile_trace_dir, mixed_precision; 3 epochs): finite
     losses, K5 launched (through the phase view too), every BatchNorm tail
     through K7 (this run's and each key's alone), the event and trace
     files, both scales, the checkpoint served; each key alone for 1 epoch
     in fp32: ms a step, launches a step, K5's launches, peak memory
     (``remat`` false, true and conv among them); the port against itself
     on the CPU (augmentation's apply and gathered indices, QAT's integers)
     and the stem_s2d step against the un-rewritten one on the card;
 21. the model-file entry points (outputs under ``build/smoke_convert/``): a
     synthetic Darknet ``yolov3.weights`` (YOLOv3-416, 80 classes, seeded,
     BN running state off its init; 248,007,048 bytes, the published file's
     size) converted on the card by ``cli convert`` (sanity check passed,
     seconds of reading, moving to the card, the 416² forward, writing),
     written back byte-identical from the ``.npz``, then served from the
     converted checkpoint: fp32 heads card vs CPU within 1e-3 at B=4, and
     ``int8_chain`` at B=16 with K1, K3, K4, K6 and K8 counted over its
     serving call (K8: 75 in fp32, the 3 heads in ``int8_chain``);
 22. phase 15's fp32 checkpoint recalibrated by ``python -m
     yolov3_tpu_torch.tools.bn_recalibrate`` at 416 over the shapes_toy
     train split (2 batches of 16): on the card exactly 144 K5 forward
     launches and none backward, then on the CPU; the state card vs CPU
     within 1e-3 of each leaf's largest value (else both against a float64
     referee), params byte-identical; the largest w/h logit of each head (on
     the served images and on a train batch) and the served boxes'
     finiteness before and after, printed as findings;
 23. the serving artifact (outputs under ``build/smoke_artifact/``): the
     seeded YOLOv3-416 in ``fp32`` and ``int8_chain`` exported for ``cuda``
     (``export/aot.py``: export and save seconds, MB, the ``yolov3_torch`` op
     nodes), loaded in a process of its own and run at B = 1, 4 and 16
     against the eager predictor (``int8_chain`` bit-equal; fp32
     index-exact, boxes 1e-5, or a near-tie witness), the exported predictor
     bit-equal to its copy from before the export, one loaded B=16 call's
     launches (``int8_chain``: K1 1, K3 11, K4 23, K6 15, K8 3; fp32: K1 1,
     K8 75; added to the ``kernels`` line), eager against loaded at B=16 in turns (event-loop
     and device-busy ms), the host's µs a call of the K1 and K3 ops against
     their direct ctypes launch, and ``int8_chain`` served from its model keys
     and from its artifact (``Serve``'s ``artifact:`` key) in turns; the fp32
     program's 8.9e-7 traced: loaded here against eager, and loaded in a
     process of its own with cuDNN's algorithm choice pinned on both sides
     (deterministic, no benchmarking);
 24. data parallelism (outputs under ``build/smoke_dp/``), the seeded
     YOLOv3-416 (3 classes, fp32 IEEE) on phase 15's first 16 shapes_toy
     images, each run a process of its own (``--dp-worker``): (a) two ranks
     on the one card over gloo, 8 images each — the data-parallel gradient
     against one process's (loss terms 1e-4, BN state 1e-4, gradient leaves
     2e-4 of the leaf max or, ill-conditioned, both against float64 on the
     card as phase 14), both ranks' state after a DP step bit-identical, K5
     and its sync all-reduces counted (72 each way a pass); (b) world size 1
     over NCCL: the DP step bit-equal to the plain step, both in turns (ms a
     step, device-busy ms), the 248 MB gradient all-reduce and one step's 72
     BN all-reduces timed; (c) ``make_predictor(mesh=)`` over ("cuda:0",
     "cuda:0") at B=16 in fp32 and ``int8_chain`` against the single
     predictor (NMS index-exact, boxes 1e-5), K1, K3, K4, K6 launched, K8
     a forward's tails on each replica (150 in fp32, 6), no host sync
     inside a sharded call, and ``Serve`` with
     ``data_parallel: true`` on one card logging the no-op and answering as
     the plain server;
 25. the spatial axis (outputs under ``build/smoke_spatial/``), the bands of
     a group on the one card: (a) the seeded 80-class YOLOv3-416 served over
     S = 2 and 4 bands at B = 16 and 1 against the unsharded predictor (fp32
     index-exact with boxes 1e-5 or a near-tie witness; ``int8`` and
     ``int8_chain`` heads and detections bit-equal), K1, K3, K4 (23 a band,
     every one a band-edge launch), K6 and K8 (a forward's tails a band:
     75 in fp32, 3 in the int8 tiers) counted, event-loop and
     device-busy ms in turns, the halo traffic of a forward; K4 with its
     halo flags against its plain version at 52² and 13² band heights
     (bit-equal) and against the whole image's launch; K5 over two bands
     against its plain version; (b) one YOLOv3-416 train step at B=16, S=2,
     fp32 IEEE, against the unsharded step whose K5 sums are taken per band
     (loss 1e-5, BN state 1e-4, every gradient leaf no farther from a
     float64 step than the larger of 2e-4 of the leaf max and twice the
     reference there), K5 144 launches each way, ms a step and peak GB
     against the plain step; (c) data 2 × spatial 2, two gloo ranks on the
     card (``--dp-worker gloo-spatial``), states bit-identical; (d) ``Serve``
     with ``spatial_partitioning: 2`` answering as the plain server; (e)
     ``evaluate`` of the trained tiny at 416 with S = 2 over [0.004, 0.5],
     counters and APs equal to the unsharded run's, K2 launched;
 25b. YOLOv4 at 608², B=2 (``config/models/yolov4/``: Mish, SPP, PAN,
     ``scale_x_y``): ``tests/test_torch_yolov4_cuda.py``'s cases in this
     process (the bf16 and fp32 predictors against the plain float32
     reference on the card, the NMS selection index for index), the spec's
     72 Mish, 35 leaky and 3 linear tails, and one profiled bf16 forward of
     the cases' seeded weights: the symbols and device ms of its kernels
     named ``mish`` (K8's ``bias_act_mish_kernel``); one call of the bf16
     predictor with K8's counts set to 0 just before it: ``conv tails fused
     110 of 110 a batch``, 110 launches;
 26. the training-quality recipe (``python -m
     yolov3_tpu_torch.tools.train_convergence``, in this process; outputs
     under ``build/smoke_convergence/``): YOLOv3-tiny at 416² trained from
     scratch on a corpus the recipe generates (1,024 train and 128 val
     images, seed 11, ``max_overlap`` 0.15; its sha256 digests against the
     same generator's on a CPU host, and both PIL versions, printed), B=64,
     ``mixed_precision``, ``device_dataset`` uint8, cosine LR, 120 epochs,
     then evaluated in bf16, ``int8`` and ``int8_chain``: epochs, steps,
     wall seconds, img/s, first and last losses, mAP@0.5 per tier, K1, K3,
     K5 (each way) and K6 launches, the served w/h logit maxima, and one B=64
     bf16 step alone (ms, device-busy ms, launches); fails unless the last
     train loss is below half the first, bf16 mAP@0.5 >= 0.2, each int8 tier
     within 0.01 of bf16, no served w/h logit above 88.72, and the four
     kernels launched;
 27. the custom-dataset transfer recipe (``python -m
     yolov3_tpu_torch.tools.pets_transfer``, in this process; outputs under
     ``build/smoke_transfer/``): YOLOv3 at 416² from phase 21's converted
     80-class checkpoint (converted here if phase 21 left none) onto the 38
     classes of the bundled pets_mini (48 + 16 photos, COCO JSON), B=8,
     bf16, the splits staged as uint8, mosaic + HSV, ``--freeze config``
     (backbone frozen, BN frozen in backbone and neck) with early stopping,
     then a short ``--freeze none``, each ending in the int8 gate: seconds,
     trained img/s, launches, best val loss, both mAPs; fails unless the
     backbone's params and the backbone's and neck's BN statistics are
     byte-identical to the source and the neck moved, K5's forward launches
     are the unfrozen BN layers × steps (all BN layers × steps under
     ``none``), every loss is finite and falls, the checkpoint's val loss
     recomputed on the card is the best epoch's after an early stop, the
     gate carries ``gate_pass``, and K1, K3 and K6 launched;
 28. the custom-dataset tools (outputs under ``build/smoke_tools/``):
     ``create_tfrecords`` of pets_mini's train split and
     ``create_yolov3_anchors`` over it (numpy's k-means), their sha256
     against a CPU host's; ``visualize_assignment`` of
     ``train_config_pets.yaml`` on the card and on the CPU, cubes bit-equal;
     ``scale_matrix`` over phase 15's fp32 YOLOv3-416 checkpoint and phase
     22's recalibration of it at 320, 416 and 608 on corpora
     ``make_toy_dataset`` generates (K1 counted), every cell filled; one
     full-width YOLOv3 predict at 608², B=16, bf16, timed.
 29. the measurement tools (``yolov3_tpu_torch/tools/``, each through its
     ``main(argv)``; each tool's printing under ``build/smoke_measure/``):
     ``bench`` in ``int8``, ``int8_chain`` and ``bf16`` (YOLOv3-416, B=128, 8
     batches a pass), ``latency_bench`` in ``int8`` and bf16 (B=1, 50
     chained predicts, 5 reps), ``profile_inference`` (B=128, 4 batches),
     ``mfu_table`` in ``int8_chain`` and ``bf16`` (B=128), ``profile_eval``
     (B=32, 608², K=512 and K=N), ``profile_train --trace`` at B=16 in bf16
     and fp32, ``bench_resblock`` at 13², 26² and 52² (B=128),
     ``bench_input_pipeline`` on phase 26's corpus at B=64 against phase
     26's trained img/s, and ``multihost_smoke`` as two gloo ranks sharing
     the card (``--multihost-smoke``); every count set to 0 just before each
     tool: fails unless each launches the kernels it runs (K1 to K6 among
     them), no ``mfu_table`` share is above 100%, ``bench_input_pipeline``
     decodes on the tier the native build gave, and the ranks' losses are
     one;
 30. the browser port's path (outputs under ``build/smoke_browser/``), with
     no TensorFlow: ``tools/export_tfjs.py`` exports phase 21's converted
     YOLOv3-416 (80 classes) in float32 and uint8, each twice from one fold
     (seconds, MB, the sha256 of model.json and of the shards; the second
     export byte-identical to the first); ``export/tfjs_runtime.GraphModel``
     runs each on the card, float32 heads within 1e-3 of the eager fp32
     forward of the same checkpoint (of a head's largest |value|), B=1 ms of
     both by CUDA events; ``tools/run_js_pipeline.py --compare`` drives
     js/src/inference.js through the port's jsvm with ``GraphModelHost`` on
     the card: the trained tiny on a shapes_toy val image (counts and classes
     equal to the compare leg's, boxes and scores within 1e-5, or a near-tie
     witness), and the float32 YOLOv3-416 export (the count equal to the
     Python pipeline's, detections well-formed, no tensor left live), then
     ``yolo_nms`` at K = N on its decoded boxes equal to ``yolo_nms_exact``;
     K1 and K2, set to 0 just before, must both launch.
Before phase 1, the native data-loader core (``native/``) is built once
(``data/native_build.py``): its tier, make's return code, the compiler it
found and the last lines of its stderr are printed on a line of their own.
Output: a JSON line of every kernel, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Needs no network and one card; imports nothing of JAX.
"""

from __future__ import annotations

import glob
import itertools
import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CALIBRATION_DIR = os.path.join(ROOT, "datasets/shapes_toy/coco/images")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# K8 launches of one YOLOv3-416 forward: fp32 and bf16 every conv's tail;
# int8 and int8_chain the three fp32 heads'
K8_A_FORWARD = (75, 3)
FP32_OPS_PER_S = 67e12     # H100 SXM fp32, outside the tensor cores
INT8_OPS_PER_S = 1979e12   # H100 SXM int8 tensor cores, dense
IOU_THR = 0.5
# serving: closed-loop clients, a warm-up then a measured window per tier
SERVE_CLIENTS = 48
SERVE_WARM_S = 2.0
SERVE_WINDOW_S = {"fp32": 5.0, "bf16": 5.0, "int8": 5.0,
                  # phase 23: the int8_chain tier from its model keys and from its artifact
                  "int8_chain": 2.0, "artifact int8_chain": 2.0}
# an image may differ end to end between card and CPU only where a
# decision of greedy NMS sits within this margin of flipping
NEAR_TIE = 1e-5


def fp32_settings():
    """fp32 as the CPU computes it: no TF32 in cuDNN's convolutions or in
    matmuls (phase 1; phase 23's process of its own sets them too)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def log(msg):
    print(msg, flush=True)


def timed(name, phase, *args):
    """Run one phase and log the seconds it took."""
    t0 = time.monotonic()
    out = phase(*args)
    log(f"phase {name}: {time.monotonic() - t0:.1f} s")
    return out


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


def host_us(fn, reps):
    """Mean host microseconds one call of ``fn`` takes to return: a host clock
    over ``reps`` calls that the device is never waited for, one synchronize
    before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def max_abs(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def phase_k1(nms_kernel):
    """K1 at the serving bucket K=512 for B = 16 (the main path's shape), 1
    and 4 (``kernel_times.K1_CASES``): identical keep masks, the event-loop
    ms, the device µs of one call (its one launch, profiler), the bound."""
    from yolov3_tpu_torch.ops.cuda.kernel_times import K1_CASES, sweep_case

    results = []
    for b, k in K1_CASES:
        mat, valid = sweep_case(b, k)
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
        profiled = device_time_by_kernel(lambda: nms_kernel.suppression_sweep(mat, valid))
        names = [n for n, _ in profiled[5]] if profiled else []
        if profiled is None or len(names) != 1:
            raise AssertionError(f"K1 at B={b} K={k}: expected one device launch, the "
                                 f"profiler saw {names}")
        # bytes this run needs: of each kept box's row only the entries
        # j > i (the rest are never read), the valid mask in, the keep mask out
        later = (k - 1 - torch.arange(k, device=keep.device))[None, :]
        need = int((later * keep).sum()) + 2 * b * k
        bound_ms = need / HBM_BYTES_PER_S * 1e3
        row = dict(B=b, K=k, equal=equal, max_abs_err=err, ms=ms, device_us=profiled[0] * 1e3,
                   plain_ms=plain_ms, bound_ms=bound_ms, bytes=need, word_steps=-(-k // 32),
                   kept_max=int(kept.max()), kept_mean=float(kept.float().mean()))
        log(f"K1 nms_sweep {json.dumps(row)}")
        if not equal:
            raise AssertionError(f"K1 differs from its plain version at B={b} K={k}")
        results.append(row)
        del mat, valid
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
    """K2 at N = 10,647 (416²) and 22,743 (608²), 100 rounds, score threshold
    0.004, for B = 16 (the main path; ``kernel_times.K2_CASES``) and the
    serving buckets 1 and 4: identical indices and counts, the cluster plan,
    ms (event loop), device µs of one call (one launch, profiler), the plain
    version's ms, the bound, and the design's latency floor: the device time
    of 100 rounds of its exchange alone (``kernel_times.round_floor``, a
    probe built apart from the kernels: a slot written, one cluster barrier,
    the slots read over distributed shared memory and folded) at the same
    cluster shape."""
    from yolov3_tpu_torch.ops.cuda.kernel_times import (K2_CASES, K2_SCORE_THR, k2_case,
                                                        round_floor)

    results = []
    for b, n in K2_CASES:
        boxes, scores = k2_case(b, n)

        def call():
            return round_sweep.round_sweep(boxes, scores, IOU_THR, K2_SCORE_THR, 100)

        sel, nv = call()
        torch.cuda.synchronize()
        rsel, rnv = round_sweep.round_sweep_ref(boxes, scores, IOU_THR, K2_SCORE_THR, 100)
        equal = torch.equal(sel, rsel) and torch.equal(nv, rnv)
        err = int(max((sel - rsel).abs().max(), (nv - rnv).abs().max()))
        ms = cuda_ms(call, 20)
        plain_ms = cuda_ms(lambda: round_sweep.round_sweep_ref(boxes, scores, IOU_THR,
                                                               K2_SCORE_THR, 100), 2)
        profiled = device_time_by_kernel(call)
        if profiled is None or len(profiled[5]) != 1:
            raise AssertionError(f"K2 at B={b} N={n}: expected one device launch, profiler saw "
                                 f"{profiled and profiled[5]}")
        floor = device_time_by_kernel(lambda: round_floor(b, n, 100))
        floor_ms = floor[0] if floor else "not measured (the profiler showed no device time)"
        need = b * n * (16 + 4) + b * 100 * 4 + b * 4
        # per box still live in a round that found one: 1 argmax compare +
        # 17 IoU ops (dead and below-threshold boxes need neither)
        ops = k2_live_visits(round_sweep, boxes, scores, sel, nv, K2_SCORE_THR) * 18
        bound_ms = max(need / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        bound_by = "bytes" if need / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S else "operations"
        row = dict(B=b, N=n, max_boxes=100, plan=round_sweep.plan(b, n), equal=equal,
                   max_abs_err=err, ms=ms, device_us=profiled[0] * 1e3, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, floor_ms=floor_ms,
                   floor_event_ms=cuda_ms(lambda: round_floor(b, n, 100), 20),
                   bytes=need, ops=ops, rounds=int(nv.max()), nv_min=int(nv.min()))
        log(f"K2 round_sweep {json.dumps(row)}")
        if not equal:
            raise AssertionError(f"K2 differs from its plain version at B={b} N={n}")
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
    predictor, app, setup_s = tier_app(tier, inference_app, serve_app)
    try:
        row = closed_loop(app, tier, bodies, setup_s)
    finally:
        app.shutdown()
    return predictor, row


def tier_app(tier, inference_app, serve_app):
    """The seeded YOLOv3-416 (80 COCO classes) of one tier behind a warmed-up
    ``DetectionApp`` with buckets [1, 4, 16] → (predictor, app, seconds)."""
    model_dir = os.path.join(ROOT, "config/models/yolov3")
    tier_keys = (dict(quantize=tier, calibration_images_dir=CALIBRATION_DIR)
                 if tier.startswith("int8") else dict(compute_precision=tier))
    t0 = time.monotonic()
    predictor, names, _ = inference_app.build_serving_predictor(
        os.path.join(model_dir, "model.yaml"),
        os.path.join(ROOT, "datasets/coco2012/coco.names"),
        os.path.join(ROOT, "datasets/coco2012/anchors.txt"),
        None, 416, yolo_max_boxes=100, nms_iou_threshold=0.5, nms_score_threshold=0.1,
        seed=0, **tier_keys)
    if len(names) != 80:
        raise AssertionError(f"expected the 80 COCO classes, got {len(names)}")
    app = serve_app.DetectionApp(predictor, names, 416, batch_buckets=(1, 4, 16),
                                 batch_timeout_ms=5)
    app.batcher.warmup((416, 416))
    torch.cuda.synchronize()
    return predictor, app, time.monotonic() - t0


def closed_loop(app, tier, bodies, setup_s):
    """``SERVE_CLIENTS`` closed-loop client threads on ``app`` (each sends its
    next request when the last one returns; enough clients to keep the 16
    bucket fillable): a ``SERVE_WARM_S`` warm-up, then a measured window of
    ``SERVE_WINDOW_S[tier]`` → the serving row (img/s, p50/p99, batches)."""
    window_s = SERVE_WINDOW_S[tier]
    latencies, finished, errors, detections = [], [], [], []
    t1 = time.monotonic()
    t_warm, t_end = t1 + SERVE_WARM_S, t1 + SERVE_WARM_S + window_s

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
    row = dict(tier=tier, client_threads=SERVE_CLIENTS, window_s=window_s,
               setup_s=setup_s, requests_in_window=len(finished),
               images_per_s=len(finished) / window_s,
               latency_samples=len(latencies), p50_ms=float(p50), p99_ms=float(p99),
               batch_histogram={k: v for k, v in hist.items() if v},
               detections=sum(detections))
    log(f"serve {json.dumps(row)}")
    return row


def phase_serve(inference_app, serve_app, models, decode, nms_mod, nms_kernel, round_sweep):
    from yolov3_tpu_torch.ops.cuda import bias_act

    bodies = encoded_requests()
    nms_kernel.suppression_sweep.launches = 0
    round_sweep.round_sweep.launches = 0
    rows, predictors = [], {}
    for tier in ("fp32", "bf16"):
        predictors[tier], row = serve_tier(tier, inference_app, serve_app, bodies)
        rows.append(row)
    k1_serving = nms_kernel.suppression_sweep.launches

    # K8 over one B=16 call of each served predictor: every fp tail fused
    images16 = smoke_images(bodies, 16)
    k8 = {f"yolov3-416 {tier}": k8_forward(bias_act, f"YOLOv3-416 {tier} B=16",
                                           lambda: predictor(images16), 75)
          for tier, predictor in predictors.items()}
    del predictors

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
                "round_sweep": round_sweep.round_sweep.launches,
                "bias_act": sum(r["launches"] for r in k8.values())}
    log(f"main path launches {json.dumps(launches)} (K1 while serving: {k1_serving})")
    if k1_serving == 0 or launches["round_sweep"] == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # the same exact NMS escalating by jumping to K = N (the default) against
    # doubling, in turns, on these heads (kernel_times.escalation_times)
    from yolov3_tpu_torch.ops.cuda.kernel_times import escalation_times

    with torch.inference_mode():
        escalation, same = escalation_times(nms_mod, boxes, conf, probs)
    row = dict(B=16, N=int(boxes.shape[1]), same_answer=same, **escalation)
    log(f"yolo_nms_exact escalation {json.dumps(row)}")
    if not same:
        raise AssertionError("yolo_nms_exact answers differ between its escalation policies")

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
    return rows, launches, k8


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


def compare_detections(nms_mod, card, cpu, nms_kw):
    """Per image, the card's served detections against the CPU's: a witness
    row for each image whose detections differ (``near_tie_witness``), and the
    largest box and score error over the images that agree."""
    gb, gc, gs, gsel, gnv = card
    cb, cc, cs, csel, cnv = cpu
    witnesses, box_err, score_err = [], 0.0, 0.0
    for i in range(gb.shape[0]):
        gi, ci = gsel[i, : int(gnv[i])].long(), csel[i, : int(cnv[i])].long()
        if int(gnv[i]) != int(cnv[i]) or not torch.equal(gc[i, gi], cc[i, ci]):
            witnesses.append(dict(image=i, detections_card=int(gnv[i]),
                                  detections_cpu=int(cnv[i]),
                                  **near_tie_witness(nms_mod, gb[i], gs[i], cb[i], cs[i],
                                                     nms_kw)))
            continue
        box_err = max(box_err, max_abs(gb[i, gi], cb[i, ci]))
        score_err = max(score_err, max_abs(gs[i, gi], cs[i, ci]))
    return witnesses, box_err, score_err


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
    (gsel, gnv), (csel, cnv) = outs["cuda"][3:], outs["cpu"][3:]
    witnesses, box_err, score_err = compare_detections(nms_mod, outs["cuda"], outs["cpu"],
                                                       nms_kw)
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


def tensor(a, dtype=None):
    return torch.as_tensor(a, dtype=dtype).cuda()


def conv_bound(in_bytes, weight_bytes, out_bytes, cout, macs):
    """(bound_ms, bound_by, bytes, ops): each input read once, the output
    written once, against 2·macs int8 operations on the tensor cores."""
    need = in_bytes + weight_bytes + 8 * cout + 4 + out_bytes
    ops = 2 * macs
    t_bytes, t_ops = need / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", need, ops


def phase_k3(conv1x1):
    """K3 at every quantized 1×1 conv of YOLOv3-416 at B=16 (the main-path
    shape first), the 13² head conv at the serving buckets 1 and 4
    (``kernel_times.K3_SHAPES``) and one ragged M: bit-equal in int8 and f32
    output, leaky on and off; the plan and the path the launch took (read off
    the profiled kernel's name), ms (event loop, int8 and f32 output), device
    µs of one launch, bound, TOP/s. The library yardstick is torch._int_mm
    (s8·s8 → s32 in device memory) followed by the epilogue as element-wise
    torch ops."""
    from yolov3_tpu_torch.ops.cuda.kernel_times import K3_SHAPES, conv1x1_case
    from yolov3_tpu_torch.ops.cuda.requant import conv_epilogue

    results = []
    for name, m, k, n, per_forward in K3_SHAPES + (("ragged M 256->128", 43227, 256, 128, 0),):
        x, w, scale, bias, inv = conv1x1_case(m, k, n)
        equal, err = True, 0.0
        for leaky in (True, False):
            for out_dtype in (torch.int8, torch.float32):
                got = conv1x1.conv1x1_int8_requant(x, w, scale, bias, inv, leaky=leaky,
                                                   out_dtype=out_dtype)
                torch.cuda.synchronize()
                want = conv1x1.conv1x1_int8_requant_plain(x, w, scale, bias, inv, leaky=leaky,
                                                          out_dtype=out_dtype)
                equal &= torch.equal(got, want)
                err = max(err, max_abs(got.float(), want.float()))
                del got, want
        ms = cuda_ms(lambda: conv1x1.conv1x1_int8_requant(x, w, scale, bias, inv, leaky=True),
                     50)
        ms_f32 = cuda_ms(lambda: conv1x1.conv1x1_int8_requant(
            x, w, scale, bias, inv, leaky=True, out_dtype=torch.float32), 50)
        plain_ms = cuda_ms(lambda: conv1x1.conv1x1_int8_requant_plain(
            x, w, scale, bias, inv, leaky=True), 3)
        wt = w.t().contiguous()

        def library():  # not used by the port: timed here as a yardstick only
            return conv_epilogue(torch._int_mm(x, wt).to(torch.float32), scale, bias, inv,
                                 True, torch.int8)

        lib_equal = torch.equal(library(), conv1x1.conv1x1_int8_requant(
            x, w, scale, bias, inv, leaky=True))
        library_ms = cuda_ms(library, 20)
        bound_ms, bound_by, need, ops = conv_bound(m * k, n * k, m * n, n, m * k * n)
        bound_f32 = conv_bound(m * k, n * k, 4 * m * n, n, m * k * n)[0]
        plan = conv1x1.plan(m, k, n)
        profiled = device_time_by_kernel(lambda: conv1x1.conv1x1_int8_requant(
            x, w, scale, bias, inv, leaky=True))
        if profiled is None or len(profiled[5]) != 1:
            raise AssertionError(f"K3 at {name}: expected one device launch, profiler saw "
                                 f"{profiled and profiled[5]}")
        kernel_name, device_ms = profiled[5][0]
        row = dict(shape=name, M=m, Cin=k, Cout=n, per_b16_forward=per_forward,
                   path=k3_path(kernel_name), plan=plan, equal=equal, max_abs_err=err, ms=ms,
                   device_us=device_ms * 1e3, ms_f32=ms_f32, plain_ms=plain_ms,
                   library_ms=library_ms, library_equal=lib_equal, bound_ms=bound_ms,
                   bound_by=bound_by, bound_f32_ms=bound_f32, bytes=need, ops=ops,
                   tops=ops / ms / 1e9)
        log(f"K3 conv1x1_int8 {json.dumps(row)}")
        if not equal:
            raise AssertionError(f"K3 differs from its plain version at {name}")
        if row["path"] != plan["path"]:
            raise AssertionError(f"K3 took the wrong path at {name}: launched {kernel_name}, "
                                 f"plan {plan}")
        results.append(row)
        del x, w, wt
        torch.cuda.empty_cache()
    return results


def k3_path(kernel_name):
    """The K3 path a profiled kernel name stands for (see ``conv1x1.plan``)."""
    for path in ("persistent", "wgmma"):
        if f"conv1x1_int8_{path}_kernel" in kernel_name:
            return path
    return "mma.sync"


def phase_k6(conv_int8):
    """K6 at ten YOLOv3-416 shapes (``kernel_times.K6_SHAPES``): the main-path
    conv and the strided conv of its stage, both convs of the space-to-depth
    stem, one 3×3 stride-1 conv per stage at B=16 and the head's 13² conv at
    the serving buckets 1 and 4. The library yardstick is a cuDNN convolution
    in TF32 over the int8 values as channels-last floats, followed by the
    epilogue as element-wise torch ops."""
    import torch.nn.functional as F

    from yolov3_tpu_torch.ops.cuda.kernel_times import K6_SHAPES, conv_case
    from yolov3_tpu_torch.ops.cuda.requant import conv_epilogue

    results = []
    for name, batch, hw, cin, cout, k, stride, pad in K6_SHAPES:
        x, kq, scale, bias, inv = conv_case(batch, hw, cin, cout, k)
        kw = dict(stride=stride, padding=pad, leaky=True)
        equal, err = True, 0.0
        for out_dtype in (torch.int8, torch.float32):
            got = conv_int8.conv_int8(x, kq, scale, bias, inv, out_dtype=out_dtype, **kw)
            torch.cuda.synchronize()
            want = conv_int8.conv_int8_plain(x, kq, scale, bias, inv, out_dtype=out_dtype, **kw)
            equal &= torch.equal(got, want)
            err = max(err, max_abs(got.float(), want.float()))
            del want
        ms = cuda_ms(lambda: conv_int8.conv_int8(x, kq, scale, bias, inv, **kw), 30)
        plain_ms = cuda_ms(lambda: conv_int8.conv_int8_plain(x, kq, scale, bias, inv, **kw), 2)
        xf = x.permute(0, 3, 1, 2).float()  # NCHW view of channels-last memory
        wf = kq.permute(0, 3, 1, 2).float().contiguous(memory_format=torch.channels_last)
        (top, bottom), (left, right) = pad

        def library():  # not used by the port: timed here as a yardstick only
            acc = F.conv2d(F.pad(xf, (left, right, top, bottom)), wf, stride=stride)
            return conv_epilogue(acc.permute(0, 2, 3, 1), scale, bias, inv, True, torch.int8)

        torch.backends.cudnn.allow_tf32 = True
        try:
            library_ms = cuda_ms(library, 10)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        b, ho, wo, _ = got.shape
        bound_ms, bound_by, need, ops = conv_bound(
            x.numel(), kq.numel(), b * ho * wo * cout, cout, b * ho * wo * cout * k * k * cin)
        plan = conv_int8.plan(b * ho * wo, cin, cout, k * k * cin)
        profiled = device_time_by_kernel(lambda: conv_int8.conv_int8(x, kq, scale, bias, inv, **kw))
        if profiled is None or len(profiled[5]) != 1:
            raise AssertionError(f"K6 at {name}: expected one device launch, profiler saw "
                                 f"{profiled and profiled[5]}")
        kernel_name, device_ms = profiled[5][0]
        launched = "wgmma" if "wgmma" in kernel_name else "mma.sync"
        row = dict(shape=name, B=batch, path=launched, tile=plan["tile"], grid=plan["grid"],
                   equal=equal, max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=need,
                   ops=ops, tops=ops / ms / 1e9)
        log(f"K6 conv_int8 {json.dumps(row)}")
        if not equal:
            raise AssertionError(f"K6 differs from its plain version at {name}")
        if launched != plan["path"] or launched != ("wgmma" if cin % 16 == 0 else "mma.sync"):
            raise AssertionError(f"K6 took the wrong path at {name}: launched {kernel_name}, "
                                 f"plan {plan}")
        results.append(row)
        del x, kq, xf, wf, got
        torch.cuda.empty_cache()
    return results


def device_time_by_kernel(fn):
    """One call of ``fn`` under torch.profiler → (ms the device was busy, {kernel name: ms},
    launches on the device, host ms of the call, {torch op: [calls, device ms]},
    [(kernel name, ms), ...] in the order the device started them).
    ``None`` when the profiler shows no device time."""
    from yolov3_tpu_torch.ops.cuda.kernel_times import profile_window

    fn()
    torch.cuda.synchronize()
    # fn's records sit between two pads the profiler may cut into, and a
    # window that lost any of them at an edge is opened again (profile_window)
    prof, host_ms, records = profile_window(fn)
    by_name, count = {}, len(records)
    for _, name, us in records:
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    total = sum(by_name.values())
    in_order = [(name, us / 1e3) for _, name, us in records]
    ops = {}
    for e in prof.key_averages():  # the torch ops that launched them, by device time
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us and e.key.startswith("aten::"):
            ops[e.key] = [e.count, us / 1e3]
    return (total, by_name, count, host_ms, ops, in_order) if total > 0 else None


def kernel_share(profiled):
    """The profile of one forward as a JSON-able dict: device-busy ms, the
    share of K3 and K6 in it, device launches, and the host's enqueue ms."""
    if profiled is None:
        return "not measured (the profiler showed no device time)"
    total, by_name, count, host_ms, ops, _ = profiled
    pick = lambda key: sum(ms for name, ms in by_name.items() if key in name)  # noqa: E731
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(device_busy_ms=total, conv1x1_int8_ms=pick("conv1x1_int8_"),
                conv_int8_ms=pick("conv_int8_"), device_launches=count,
                host_enqueue_ms=host_ms, top=[[n[:60], ms] for n, ms in top],
                torch_ops=dict(sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]))


def profile_recording(conv1x1, conv_int8, forward):
    """``device_time_by_kernel(forward)`` with every K6 call of the profiled
    run recorded as (B, H, W, Cin, Cout, k, stride, Ho, Wo) and every K3 call
    as (M, Cin, Cout, output bytes an element), in call order."""
    from yolov3_tpu_torch.models import layers

    runs, real_k6, real_k3 = [], layers.conv_int8, layers.conv1x1_int8_requant

    def recording_k6(xq, kq, *args, **kw):
        b, h, w, cin = xq.shape
        cout, k = kq.shape[0], kq.shape[1]
        runs[-1][0].append((b, h, w, cin, cout, k, kw["stride"],
                            conv_int8.out_size(h, k, kw["stride"], kw["padding"][0]),
                            conv_int8.out_size(w, k, kw["stride"], kw["padding"][1])))
        return real_k6(xq, kq, *args, **kw)

    def recording_k3(xq, wq, *args, **kw):
        out_dtype = kw.get("out_dtype", torch.int8)
        runs[-1][1].append((xq.shape[0], xq.shape[1], wq.shape[0],
                            4 if out_dtype == torch.float32 else 1))
        return real_k3(xq, wq, *args, **kw)

    def recorded_forward():
        runs.append(([], []))
        return forward()

    layers.conv_int8, layers.conv1x1_int8_requant = recording_k6, recording_k3
    try:
        profiled = device_time_by_kernel(recorded_forward)
    finally:
        layers.conv_int8, layers.conv1x1_int8_requant = real_k6, real_k3
    return (profiled, *runs[-1])  # the last run is the one the profile shows


def k3_launches_by_shape(profiled, calls, batch):
    """K3's launches of one forward grouped by shape as ``k6_launches_by_shape``
    does for K6, with the path each launch took. Raises if a conv with
    Cin % 16 == 0 ran the mma.sync kernel."""
    if profiled is None:
        return "not measured (the profiler showed no device time)"
    kernels = [(n, ms) for n, ms in profiled[5] if "conv1x1_int8_" in n]
    if len(kernels) != len(calls):
        raise AssertionError(f"{len(calls)} K3 calls but {len(kernels)} K3 kernels profiled")
    groups = {}
    for (m, cin, cout, esize), (name, ms) in zip(calls, kernels):
        path = k3_path(name)
        if cin % 16 == 0 and path == "mma.sync":
            raise AssertionError(f"K3 ran {name} for a 1×1 conv with Cin = {cin}")
        key = f"{round((m / batch) ** 0.5)}^2 {cin}->{cout}"
        bound_ms, bound_by, _, ops = conv_bound(m * cin, cout * cin, esize * m * cout, cout,
                                                m * cin * cout)
        g = groups.setdefault(key, dict(shape=key, out_bytes=esize, count=0, ms_sum=0.0,
                                        bound_ms=bound_ms, bound_by=bound_by, ops=ops, paths=[]))
        g["count"] += 1
        g["ms_sum"] += ms
        if path not in g["paths"]:
            g["paths"].append(path)
    rows = []
    for g in groups.values():
        ms = g.pop("ms_sum") / g["count"]
        rows.append(dict(g, ms=ms, tops=g["ops"] / ms / 1e9,
                         launches_x_gap_ms=g["count"] * (ms - g["bound_ms"])))
    return sorted(rows, key=lambda r: -r["launches_x_gap_ms"])


def k6_launches_by_shape(profiled, calls):
    """K6's launches of one forward grouped by shape, largest launches × gap
    first: count, device ms of one launch (mean), its bound, and count ×
    (ms − bound). The profiler's K6 kernels, in device order, are matched to
    the recorded calls one to one."""
    if profiled is None:
        return "not measured (the profiler showed no device time)"
    kernels = [(n, ms) for n, ms in profiled[5] if "conv_int8_" in n]
    if len(kernels) != len(calls):
        raise AssertionError(f"{len(calls)} K6 calls but {len(kernels)} K6 kernels profiled")
    groups = {}
    for (b, h, w, cin, cout, k, stride, ho, wo), (name, ms) in zip(calls, kernels):
        key = f"{k}x{k} s{stride} {h}^2 {cin}->{cout}"
        bound_ms, bound_by, _, ops = conv_bound(b * h * w * cin, cout * k * k * cin,
                                                b * ho * wo * cout, cout,
                                                b * ho * wo * cout * k * k * cin)
        g = groups.setdefault(key, dict(shape=key, count=0, ms_sum=0.0, bound_ms=bound_ms,
                                        bound_by=bound_by, ops=ops,
                                        path="wgmma" if "wgmma" in name else "mma.sync"))
        g["count"] += 1
        g["ms_sum"] += ms
    rows = []
    for g in groups.values():
        ms = g.pop("ms_sum") / g["count"]
        rows.append(dict(g, ms=ms, tops=g["ops"] / ms / 1e9,
                         launches_x_gap_ms=g["count"] * (ms - g["bound_ms"])))
    return sorted(rows, key=lambda r: -r["launches_x_gap_ms"])


def smoke_images(bodies, n, size=416):
    from yolov3_tpu_torch.data.image import decode_image, resize_bilinear

    return np.stack([resize_bilinear(decode_image(bodies[i % len(bodies)]) / 255.0, size, size)
                     for i in range(n)]).astype(np.float32)


def phase_int8_forward(models, inference_app, bodies, conv1x1, conv_int8):
    """YOLOv3-416 at full width, seeded weights, calibrated once on the card
    on 8 smoke images; for ``int8`` and ``int8_chain`` the SAME quantized
    params run on the card and on the CPU (calibration itself is not
    bit-portable: it reads absmax off an fp forward). Held: every quantized
    layer's output bit-equal (between quantized layers all arithmetic is
    integer or element-wise f32), heads within 1e-3 (one fp conv each).
    Each mode also answers a B=16 batch through ``make_predictor``, which
    calibrates for itself. Returns the chain-mode spec and params for the K4
    stage runs."""
    from yolov3_tpu_torch.config import get_anchors, read_class_names
    from yolov3_tpu_torch.models import network
    from yolov3_tpu_torch.models.network import to_device
    from yolov3_tpu_torch.ops.cuda import resblock
    from yolov3_tpu_torch.ops.quantize import calibrate_scales, quantize_params
    from yolov3_tpu_torch.ops.s2d import s2d_stem

    names = read_class_names(os.path.join(ROOT, "datasets/coco2012/coco.names"))
    spec0 = models.parse_model_config(os.path.join(ROOT, "config/models/yolov3/model.yaml"),
                                      len(names))
    params, state = models.init_model(spec0, torch.Generator().manual_seed(0))
    folded = to_device(models.fold_batch_norm(params, state), "cuda")
    calibration = [smoke_images(bodies, 8)]
    in_absmax, out_absmax = calibrate_scales(spec0, folded, calibration)
    anchors = get_anchors(os.path.join(ROOT, "datasets/coco2012/anchors.txt"))
    pair = torch.from_numpy(smoke_images(bodies, 2))
    batch = torch.from_numpy(smoke_images(bodies, 16)).cuda()
    rows, chain = [], None
    for mode in ("int8", "int8_chain"):
        q = quantize_params(spec0, folded, in_absmax,
                            out_absmax=out_absmax if mode == "int8_chain" else None)
        spec, q = s2d_stem(spec0, q, image_size=416)
        if mode == "int8_chain":  # the blocks' constant K4 arguments, as make_predictor packs
            q = network.pack_fused_stages(spec, q)
        quantized = [(sm, key) for sm in q for key, e in q[sm].items()
                     if "kernel_q" in e or set(e) == {"out_scale"}]
        seen = {}
        with torch.inference_mode():
            heads = {}
            for dev in ("cuda", "cpu"):
                taps = seen.setdefault(dev, {})
                heads[dev] = models.apply_model(
                    spec, to_device(q, dev), {}, pair.to(dev),
                    out_observer=lambda sm, key, x, taps=taps: taps.__setitem__(
                        (sm, key), x.cpu()) if (sm, key) in quantized else None)
        unequal = [tap for tap in quantized
                   if not torch.equal(seen["cuda"][tap], seen["cpu"][tap])]
        head_err = max(max_abs(g.cpu(), c) for g, c in zip(heads["cuda"], heads["cpu"]))
        finite = all(bool(torch.isfinite(h).all()) for h in heads["cuda"])
        conv1x1.conv1x1_int8_requant.launches = conv_int8.conv_int8.launches = 0
        resblock.fused_resblock.launches = 0
        with torch.inference_mode():
            models.apply_model(spec, q, {}, batch)
            launches = dict(conv1x1_int8=conv1x1.conv1x1_int8_requant.launches,
                            conv_int8=conv_int8.conv_int8.launches,
                            resblock_int8=resblock.fused_resblock.launches)
            fwd = cuda_ms(lambda: models.apply_model(spec, q, {}, batch), 5)
            raw, k6_calls, k3_calls = profile_recording(
                conv1x1, conv_int8, lambda: models.apply_model(spec, q, {}, batch))
            profiled = kernel_share(raw)
            k6_by_shape = k6_launches_by_shape(raw, k6_calls)
            k3_by_shape = k3_launches_by_shape(raw, k3_calls, 16)
        predictor = inference_app.make_predictor(
            spec0, params, state, anchors, len(names), 100, 0.5, 0.1, quantize=mode,
            calibration_batches=calibration, image_size=416)
        boxes, _, scores, selected, num_valid = predictor(batch)
        torch.cuda.synchronize()
        predictor_ms = cuda_ms(lambda: predictor(batch), 3)
        if (tuple(selected.shape) != (16, 100) or not bool(torch.isfinite(boxes).all())
                or not bool(torch.isfinite(scores).all()) or int(num_valid.min()) == 0):
            raise AssertionError(f"{mode}: make_predictor's answer is malformed")
        row = dict(mode=mode, quantized_layers=len(quantized), layers_unequal=len(unequal),
                   first_unequal=[list(t) for t in unequal[:3]], head_max_abs_err=head_err,
                   forward_ms_b16=fwd, predictor_ms_b16=predictor_ms,
                   detections_b16=int(num_valid.sum()), launches_per_forward=launches,
                   profile=profiled, conv_int8_by_shape=k6_by_shape,
                   conv1x1_int8_by_shape=k3_by_shape)
        log(f"int8 forward YOLOv3-416 card vs CPU {json.dumps(row)}")
        if unequal or not finite or head_err > 1e-3:
            raise AssertionError(f"{mode}: the card disagrees with the CPU: {row}")
        if launches["conv1x1_int8"] == 0 or launches["conv_int8"] == 0:
            raise AssertionError(f"{mode}: a forward did not go through K3 and K6: {launches}")
        # int8_chain runs every residual stage through K4, one launch a
        # block (Darknet-53: 23); the int8 tier (fp shortcuts) none
        sm = spec.sub_models[0]
        routed = sum(len(st) for st in network._fusable_stages(sm, q[sm.name]).values())
        if launches["resblock_int8"] != routed or routed != (23 if mode == "int8_chain" else 0):
            raise AssertionError(f"{mode}: {launches['resblock_int8']} K4 launches a forward, "
                                 f"expected {routed}")
        if mode == "int8_chain":
            row["k4_routing"] = k4_routing(models, spec, q, pair, batch, heads["cuda"])
            log(f"int8_chain forward through K4 {json.dumps(row['k4_routing'])}")
        rows.append(row)
        chain = (spec, q)
    return rows, chain, batch


def k4_routing(models, spec, q, pair, batch, unrouted_heads):
    """``int8_chain`` with its residual stages through K4 against none: the
    B=16 forward's device-busy ms (profiler) and event-loop ms both ways, in
    turns (none, routed, routed, none; "none" runs with no stage admitted to
    K4); the routed forward's heads must be bit-equal to the unrouted
    forward's on the card (``unrouted_heads``, the same two images) and
    within 1e-3 of the same routed forward on the CPU (there K4's plain
    version)."""
    from yolov3_tpu_torch.models import network
    from yolov3_tpu_torch.models.network import to_device

    admitted = network._fusable_stages
    out = {name: dict(ms=[], device_ms=[]) for name in ("none", "routed")}
    try:
        for name in ("none", "routed", "routed", "none"):
            network._fusable_stages = admitted if name == "routed" else lambda sm, p: {}
            with torch.inference_mode():
                out[name]["ms"].append(cuda_ms(lambda: models.apply_model(spec, q, {}, batch), 5))
                profiled = device_time_by_kernel(lambda: models.apply_model(spec, q, {}, batch))
            out[name]["device_ms"].append(profiled[0] if profiled else None)
    finally:
        network._fusable_stages = admitted
    with torch.inference_mode():
        routed = models.apply_model(spec, q, {}, pair.cuda())
        torch.cuda.synchronize()
        cpu = models.apply_model(spec, to_device(q, "cpu"), {}, pair)
    equal = all(torch.equal(r, u) for r, u in zip(routed, unrouted_heads))
    err = max(max_abs(r.cpu(), c) for r, c in zip(routed, cpu))
    row = dict(out, heads_equal_to_unrouted=equal, heads_max_abs_err_vs_cpu=err)
    if not equal or err > 1e-3:
        raise AssertionError(f"int8_chain routed through K4 disagrees: {row}")
    return row


def phase_k4(models, resblock, chain, batch):
    """The residual stages of the chain-quantized YOLOv3-416 at B=16: each
    stage's blocks through K4 chained in halo layout against the unfused
    chain K3 → K6 → add_requant on the same int8 input (the backbone's own
    activation there). Held: stage outputs bit-equal, and one K4 block per
    stage bit-equal to its plain version, at B=16 and at the serving
    buckets B=1 and 4 (the first images). Timed at B=16, in turns (fused,
    unfused, unfused, fused): each stage both ways, by event loop and by the
    device time of one run (profiler, every kernel it launches), and one K4
    block alone (device µs of its one launch)."""
    from yolov3_tpu_torch.models import layers as L
    from yolov3_tpu_torch.models import network
    from yolov3_tpu_torch.models.spec import SubModelSpec
    from yolov3_tpu_torch.parallel import spatial

    spec, q = chain
    sm = spec.sub_models[0]
    sm_q = q[sm.name]
    stages = resblock.residual_blocks(sm)
    if [len(st) for st in stages] != [1, 2, 8, 8, 4]:
        raise AssertionError(f"Darknet-53 has residual stages 1, 2, 8, 8, 4, found {stages}")
    # every stage's real input: the backbone cut off before each stage
    feeders = SubModelSpec(name=sm.name, layers=sm.layers[:stages[-1][0]], inputs=sm.inputs,
                           outputs_layers=tuple(st[0] - 1 for st in stages),
                           input_shape=sm.input_shape)
    with torch.inference_mode():
        inputs = [out.parts[0] for out in network._apply_sub_model(
            feeders, sm_q, {}, spatial.whole(batch.permute(0, 3, 1, 2)), spec.nclasses,
            torch.float32)]

        def unfused(x, starts):
            for i in starts:
                a = L.conv2d_int8(x, sm_q[f"layer{i}"], 1, 1, leaky=True)
                a = L.conv2d_int8(a, sm_q[f"layer{i + 1}"], 1, 1, leaky=True)
                x = L.add_requant(x, a, sm_q[f"layer{i + 2}"]["out_scale"])
            return x

        def device_ms(fn):
            profiled = device_time_by_kernel(fn)
            return profiled[0] if profiled else None

        # K4's path, driven once with the count at 0: all five stages
        resblock.fused_resblock.launches = 0
        fused_out = [resblock.fused_stage((x.q, x.scale), sm_q, st)
                     for x, st in zip(inputs, stages)]
        torch.cuda.synchronize()
        path_launches = resblock.fused_resblock.launches

        rows = []
        for x, st, (fq, fscale) in zip(inputs, stages, fused_out):
            if not isinstance(x, L.QAct):
                raise AssertionError("the chain-mode backbone should feed int8 to every stage")
            b, h, w, c = x.q.shape
            want = unfused(x, st)
            stage_equal = torch.equal(fq, want.q) and float(fscale) == float(want.scale)
            kwargs, _ = resblock.block_args(sm_q[f"layer{st[0]}"], sm_q[f"layer{st[0] + 1}"],
                                            sm_q[f"layer{st[0] + 2}"], x.scale)
            xp = resblock.to_halo(x.q)
            got = resblock.fused_resblock(xp, **kwargs, b=b, h=h, w=w)
            plain = resblock.fused_resblock_plain(xp, **kwargs, b=b, h=h, w=w)
            block_equal = torch.equal(got, plain)
            err = int((got.int() - plain.int()).abs().max())
            # the serving buckets: the stage and one block on the first images
            small_equal = {}
            for bs in (1, 4):
                xs = L.QAct(x.q[:bs].contiguous(), x.scale)
                sq, sscale = resblock.fused_stage((xs.q, xs.scale), sm_q, st)
                swant = unfused(xs, st)
                sxp = resblock.to_halo(xs.q)
                small_equal[bs] = (torch.equal(sq, swant.q) and float(sscale) == float(swant.scale)
                                   and torch.equal(
                                       resblock.fused_resblock(sxp, **kwargs, b=bs, h=h, w=w),
                                       resblock.fused_resblock_plain(sxp, **kwargs, b=bs, h=h,
                                                                     w=w)))
            ms = cuda_ms(lambda: resblock.fused_resblock(xp, **kwargs, b=b, h=h, w=w), 10)
            block = device_time_by_kernel(
                lambda: resblock.fused_resblock(xp, **kwargs, b=b, h=h, w=w))
            if block is None or len(block[5]) != 1:
                raise AssertionError(f"K4 at {h}^2: expected one device launch, profiler saw "
                                     f"{block and block[5]}")
            plain_ms = cuda_ms(lambda: resblock.fused_resblock_plain(xp, **kwargs, b=b, h=h,
                                                                      w=w), 2)

            def fused_run():
                return resblock.fused_stage((x.q, x.scale), sm_q, st)

            def unfused_run():
                return unfused(x, st)

            turns = {"fused": dict(ms=[], device_ms=[]), "unfused": dict(ms=[], device_ms=[])}
            for name, fn in (("fused", fused_run), ("unfused", unfused_run),
                             ("unfused", unfused_run), ("fused", fused_run)):
                turns[name]["ms"].append(cuda_ms(fn, 5))
                turns[name]["device_ms"].append(device_ms(fn))
            cm = c // 2
            bound_ms, bound_by, need, ops = conv_bound(
                xp.numel(), 10 * c * cm + 8 * cm, xp.numel(), c, b * h * w * 10 * c * cm)
            row = dict(stage=f"{h}^2 C={c}", B=b, blocks=len(st), plan=resblock.plan(
                b, h, w, c, cm), stage_equal_to_unfused=stage_equal, equal=block_equal,
                equal_b1_b4=small_equal, max_abs_err=err, ms=ms, device_us=block[0] * 1e3,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=need, ops=ops,
                tops=ops / (block[0] * 1e-3) / 1e12, stage_fused=turns["fused"],
                stage_unfused=turns["unfused"], distinct_values=int(torch.unique(fq).numel()))
            log(f"K4 resblock_int8 {json.dumps(row)}")
            if not (stage_equal and block_equal and all(small_equal.values())):
                raise AssertionError(f"K4 disagrees at stage {row['stage']}")
            rows.append(row)
            del xp, got, plain
    if path_launches != sum(len(st) for st in stages):
        raise AssertionError(f"K4 launched {path_launches} times over the stage runs")
    return rows, path_launches


def phase_trained_int8(inference_app, models, nms_mod):
    """Trained YOLOv3-tiny, ``int8_chain`` (maxpools and the upsample stay
    int8): calibrated once on the card on 8 of the images, the same quantized
    params then serve all 32 images on the card and on the CPU through
    ``make_predictor``; held like the fp32 run (an image may differ only with
    a near-tie witness). Against the fp32 detections: printed only."""
    from yolov3_tpu_torch.config import get_anchors, read_class_names
    from yolov3_tpu_torch.data.image import decode_image, resize_bilinear
    from yolov3_tpu_torch.io.resolve import load_weights
    from yolov3_tpu_torch.models.network import to_device
    from yolov3_tpu_torch.ops.quantize import calibrate_scales, quantize_params

    files = sorted(glob.glob(os.path.join(CALIBRATION_DIR, "*.jpg")))
    images = np.stack([resize_bilinear(decode_image(open(f, "rb").read()) / 255.0, 416, 416)
                       for f in files]).astype(np.float32)
    names = os.path.join(ROOT, "datasets/shapes_toy/class.names")
    nc = len(read_class_names(names))
    anchors = get_anchors(os.path.join(ROOT, "datasets/shapes_toy/anchors/anchors_tiny.txt"))
    spec = models.parse_model_config(os.path.join(ROOT, "config/models/yolov3_tiny/model.yaml"),
                                     nc)
    params, state = models.init_model(spec, torch.Generator().manual_seed(0))
    params, state = load_weights(spec, params, state,
                                 os.path.join(ROOT, "checkpoints/output/yolov3_train_tiny.tf"))
    folded = to_device(models.fold_batch_norm(params, state), "cuda")
    in_absmax, out_absmax = calibrate_scales(spec, folded, [images[:8]])
    q = quantize_params(spec, folded, in_absmax, out_absmax=out_absmax)
    nms_kw = dict(max_boxes=100, iou_threshold=0.5, score_threshold=0.1)
    args = (anchors, nc, 100, 0.5, 0.1)
    outs = {dev: [t.cpu() for t in inference_app.make_predictor(
        spec, to_device(q, dev), {}, *args, fold_bn=False, device=dev)(images)]
        for dev in ("cuda", "cpu")}
    fp32 = [t.cpu() for t in inference_app.make_predictor(spec, params, state, *args)(images)]
    witnesses, box_err, score_err = compare_detections(nms_mod, outs["cuda"], outs["cpu"],
                                                       nms_kw)
    fp_diff, fp_box, fp_score = compare_detections(nms_mod, outs["cuda"], fp32, nms_kw)
    row = dict(images=len(files), detections_card=int(outs["cuda"][4].sum()),
               detections_cpu=int(outs["cpu"][4].sum()), images_differing=witnesses,
               box_max_abs_err=box_err, score_max_abs_err=score_err,
               vs_fp32=dict(detections_fp32=int(fp32[4].sum()),
                            images_identical=len(files) - len(fp_diff),
                            max_abs_score_diff_all_candidates=max_abs(outs["cuda"][2], fp32[2]),
                            box_max_abs_err_identical=fp_box,
                            score_max_abs_err_identical=fp_score))
    log(f"trained tiny int8_chain card vs CPU {json.dumps(row)}")
    unexplained = [w["image"] for w in witnesses
                   if w["margin"] is None or w["margin"] > NEAR_TIE]
    if unexplained or box_err > 1e-3 or score_err > 1e-4 or int(outs["cuda"][4].sum()) == 0:
        raise AssertionError(f"trained tiny int8_chain: card vs CPU beyond tolerance {row}")


def phase_k5(bn_stats):
    """K5 forward and backward at B=16 shapes of YOLOv3-416 and one odd
    shape (``kernel_times.K5_SHAPES``), f32 and bf16, both memory formats.
    Beside ``ms`` (a loop of calls between two events: the larger of the
    host's and the device's cost of a call) each row has the device time of
    one call from torch.profiler and the host's microseconds a call. The
    library yardsticks are torch.batch_norm_stats (one call: mean and invstd)
    and torch.var_mean (biased); neither is used by the port. Then two calls
    at once on two streams."""
    from yolov3_tpu_torch.ops.cuda.kernel_times import K5_SHAPES

    def one_launch_each(x, mean, dmean, dvar):
        """Device µs of one forward and one backward call, which must be one
        launch each: both run in one profiler window."""
        def both():
            moments_no_grad(x)
            bn_stats.bn_moments_dx(x, mean, dmean, dvar)

        profiled = device_time_by_kernel(both)
        if profiled is None:
            raise AssertionError("K5: the profiler showed no device time")
        names = [n for n, _ in profiled[5]]
        if len(names) != 2 or "bn_moments_" not in names[0] or "bn_dx_kernel" not in names[1]:
            raise AssertionError(f"K5: expected one launch of bn_moments_* and one of "
                                 f"bn_dx_kernel, saw {names}")
        return profiled[5][0][1] * 1e3, profiled[5][1][1] * 1e3

    def moments_no_grad(x):
        with torch.no_grad():
            return bn_stats.bn_moments(x)

    results = []
    for shape in K5_SHAPES:
        b, c, h, w = shape
        n = b * h * w
        gen = torch.Generator(device="cuda").manual_seed(c * h)
        base = torch.randn(shape, generator=gen, device="cuda") * 2.0
        base += torch.randn((1, c, 1, 1), generator=gen, device="cuda") * 3.0
        base[:, 0] = 1.5  # a constant channel: its variance clamps at 0
        dmean = torch.randn(c, generator=gen, device="cuda")
        dvar = torch.randn(c, generator=gen, device="cuda")
        reps = 20 if base.numel() > 1 << 24 else 50
        for dtype in (torch.float32, torch.bfloat16):
            for channels_last in (True, False):
                x = base.to(dtype).contiguous(
                    memory_format=torch.channels_last if channels_last
                    else torch.contiguous_format)
                s1, q1 = bn_stats.bn_sums(x)
                torch.cuda.synchronize()
                s2, q2 = bn_stats.bn_sums(x)
                same_bits = torch.equal(s1, s2) and torch.equal(q1, q2)
                ref_s = x.sum(dim=(0, 2, 3), dtype=torch.float64)
                ref_abs = x.abs().sum(dim=(0, 2, 3), dtype=torch.float64)
                ref_q = (x.double() * x.double()).sum(dim=(0, 2, 3))
                ps, pq = bn_stats.bn_sums_plain(x)
                err = max(float(((s1.double() - ref_s).abs() / ref_abs).max()),
                          float(((q1.double() - ref_q).abs() / ref_q).max()))
                plain_err = max(float(((ps.double() - ref_s).abs() / ref_abs).max()),
                                float(((pq.double() - ref_q).abs() / ref_q).max()))
                del ref_s, ref_abs, ref_q
                # the kernel's mean and var against the plain expression, evaluated
                # by PyTorch on the card from the kernel's own sums
                mean, var = moments_no_grad(x)
                want_mean = s1 / n
                want_var = torch.clamp(q1 / n - want_mean * want_mean, min=0.0)
                moments_equal = torch.equal(mean, want_mean) and torch.equal(var, want_var)
                dx = bn_stats.bn_moments_dx(x, mean, dmean, dvar)
                torch.cuda.synchronize()
                want = bn_stats.bn_moments_dx_plain(x, mean, dmean, dvar)
                dx_equal = (torch.equal(dx, want) and dx.dtype == x.dtype
                            and dx.stride() == x.stride())
                dx_err = max_abs(dx.float(), want.float())
                del dx, want
                ms = cuda_ms(lambda: moments_no_grad(x), reps)
                device_us, dx_device_us = one_launch_each(x, mean, dmean, dvar)
                call_us = host_us(lambda: moments_no_grad(x), reps)
                plain_ms = cuda_ms(lambda: bn_stats.bn_sums_plain(x), 5)
                dx_ms = cuda_ms(lambda: bn_stats.bn_moments_dx(x, mean, dmean, dvar), reps)
                dx_call_us = host_us(lambda: bn_stats.bn_moments_dx(x, mean, dmean, dvar), reps)
                dx_plain_ms = cuda_ms(
                    lambda: bn_stats.bn_moments_dx_plain(x, mean, dmean, dvar), 5)
                # yardsticks, timed here and used nowhere in the port
                stats_ms = cuda_ms(lambda: torch.batch_norm_stats(x, 1e-3), reps)
                stats_us = host_us(lambda: torch.batch_norm_stats(x, 1e-3), reps)
                var_mean_ms = cuda_ms(
                    lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0), reps)
                nbytes = x.numel() * x.element_size()
                row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                           memory="channels_last" if channels_last else "nchw",
                           plan=list(bn_stats._plan(channels_last, b, c, h * w)),
                           equal=(same_bits and dx_equal and moments_equal
                                  and err <= bn_stats.SUM_RTOL),
                           bit_identical_relaunch=same_bits, max_abs_err=err,
                           plain_sum_err=plain_err, moments_equal=moments_equal,
                           dx_equal=dx_equal, dx_max_abs_err=dx_err,
                           ms=ms, device_us=device_us, host_us=call_us, launches_per_call=1,
                           plain_ms=plain_ms, library_ms=min(stats_ms, var_mean_ms),
                           batch_norm_stats_ms=stats_ms, batch_norm_stats_host_us=stats_us,
                           var_mean_ms=var_mean_ms,
                           bound_ms=(nbytes + 16 * c) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                           bytes=nbytes, gb_per_s=nbytes / ms / 1e6,
                           backward_ms=dx_ms, backward_device_us=dx_device_us,
                           backward_host_us=dx_call_us, backward_plain_ms=dx_plain_ms,
                           backward_bound_ms=(2 * nbytes + 12 * c) / HBM_BYTES_PER_S * 1e3,
                           backward_gb_per_s=2 * nbytes / dx_ms / 1e6)
                log(f"K5 bn_stats {json.dumps(row)}")
                if not row["equal"]:
                    raise AssertionError(f"K5 disagrees at {shape} {dtype} "
                                         f"channels_last={channels_last}: {row}")
                results.append(row)
                del x
        del base
        torch.cuda.empty_cache()

    # two calls at once on two streams: each stream has its own workspace
    inputs = [torch.randn((16, 256, 52, 52), device="cuda") + 1.0,
              torch.randn((16, 64, 208, 208), device="cuda") * 3.0]
    want = [[t.clone() for t in moments_no_grad(x)] for x in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for _ in range(10):
        for i, (stream, x) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(stream):
                got[i].append(moments_no_grad(x))
    torch.cuda.synchronize()
    streams_equal = all(torch.equal(m, want[i][0]) and torch.equal(v, want[i][1])
                        for i in range(2) for m, v in got[i])
    log(f"K5 bn_stats two streams {json.dumps(dict(calls=20, equal=streams_equal))}")
    if not streams_equal:
        raise AssertionError("K5: concurrent calls on two streams disagree with serial ones")
    return results


def k7_sums_error(x, dy, got, mean, var, gamma, beta, eps, slope, rtol):
    """How far K7's (C,) gradients ``got[1:]`` (dmean, dvar, dgamma, dbeta)
    lie from their formulas over float64 sums of the same terms, each error
    less 2^-21 of the value (the finishing products) and, for bf16
    parameters, 2^-8 (their rounding), as a share of the sums' Σ|term|:
    (largest share, every share within ``rtol``)."""
    view = (1, -1, 1, 1)
    r = torch.rsqrt(var + eps)
    s = (gamma.float() * r).to(x.dtype)
    d = x - mean.to(x.dtype).view(view)
    v = d * s.view(view) + beta.to(x.dtype).view(view)
    g = torch.where(v >= 0, dy.float(), dy.float() * slope).double()
    del v
    gd = g * d.double()
    del d
    s0, s1 = g.sum(dim=(0, 2, 3)), gd.sum(dim=(0, 2, 3))
    a0, a1 = g.abs().sum(dim=(0, 2, 3)), gd.abs().sum(dim=(0, 2, 3))
    del g, gd
    r64, s64, gamma64 = r.double(), s.double(), gamma.double()
    rounding = 2.0 ** -8 if gamma.dtype == torch.bfloat16 else 0.0
    worst, within = 0.0, True
    for value, ref, scale, rnd in (
            (got[1], -s64 * s0, a0 * s64.abs(), 0.0),
            (got[2], -0.5 * s1 * gamma64 * r64 ** 3, a1 * 0.5 * gamma64 * r64 ** 3, 0.0),
            (got[3], s1 * r64, a1 * r64, rounding), (got[4], s0, a0, rounding)):
        err = (value.double() - ref).abs() - (rnd + 2.0 ** -21) * ref.abs()
        within = within and bool((err <= rtol * scale).all())
        worst = max(worst, float((err.clamp(min=0.0) / scale.clamp(min=1e-300)).max()))
    return worst, within


def phase_k7(bn_leaky, bn_stats):
    """K7 forward and backward at each distinct BatchNorm tail of YOLOv3-416
    at B=64, bf16 in channels-last memory: the tails of the train cell's step
    (``kernel_times.K7_TAILS``), largest first. y bit-equal to the plain
    version (``bn_leaky_plain``) evaluated on the card, dx bit-equal to
    ``bn_leaky_dx_plain``, dmean, dvar, dgamma and dbeta within ``SUM_RTOL``
    of float64 sums (``k7_sums_error``), two launches the same bits each way,
    one device kernel each way (profiler), y and dx in x's memory format.
    Each row: the event-loop ms, device µs and host µs a call each way, the
    bytes bound (forward: x read, y written; backward: x and dy read, dx
    written; at ``HBM_BYTES_PER_S``) and the device time's share of it, and
    the plain versions' ms (the forward; autograd's forward and backward).
    Then the sums over the model's tails, a tail counted as often as the
    model has it → (rows, sums)."""
    from yolov3_tpu_torch.models import layers
    from yolov3_tpu_torch.ops.cuda.kernel_times import K7_TAILS

    model, batch, tails = K7_TAILS[0]
    eps, slope = layers.BN_EPS, layers.LEAKY_SLOPE

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    def forward(x, args):
        with torch.no_grad():
            return bn_leaky.bn_leaky(x, *args)

    def one_launch_each(x, dy, args):
        """Device µs of one forward and one backward call, which must be one
        launch each: both run in one profiler window."""
        profiled = device_time_by_kernel(lambda: (forward(x, args),
                                                  bn_leaky.bn_leaky_dx(x, dy, *args)))
        if profiled is None:
            raise AssertionError("K7: the profiler showed no device time")
        names = [n for n, _ in profiled[5]]
        if (len(names) != 2 or "bn_leaky_fwd_" not in names[0]
                or "bn_leaky_bwd_" not in names[1]):
            raise AssertionError(f"K7: expected one launch of bn_leaky_fwd_* and one of "
                                 f"bn_leaky_bwd_*, saw {names}")
        return profiled[5][0][1] * 1e3, profiled[5][1][1] * 1e3

    rows = []
    for (c, hw), count in sorted(tails.items(), key=lambda kv: -kv[0][0] * kv[0][1] ** 2):
        shape = (batch, c, hw, hw)
        gen = torch.Generator(device="cuda").manual_seed(c * hw)
        x = torch.randn(shape, generator=gen, device="cuda") * 2.0
        x += torch.randn((1, c, 1, 1), generator=gen, device="cuda") * 3.0
        x[:, 0] = 1.5  # a constant channel: zero variance, its pre-activation exactly 0
        x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        dy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        with torch.no_grad():
            mean, var = bn_stats.bn_moments(x)
        gamma = (torch.rand(c, generator=gen, device="cuda") * 0.4 + 0.8).to(torch.bfloat16)
        beta = (torch.rand(c, generator=gen, device="cuda") * 0.4 - 0.2).to(torch.bfloat16)
        beta[0] = 0
        args = (mean, var, gamma, beta, eps, slope)
        y, again = forward(x, args), forward(x, args)
        want = bn_leaky.bn_leaky_plain(x, *args)
        torch.cuda.synchronize()
        fwd_equal = torch.equal(bits(y), bits(want)) and y.stride() == x.stride()
        same_bits = torch.equal(bits(y), bits(again))
        del y, again, want
        got = bn_leaky.bn_leaky_dx(x, dy, *args)
        got2 = bn_leaky.bn_leaky_dx(x, dy, *args)
        plain = bn_leaky.bn_leaky_dx_plain(x, dy, *args)
        torch.cuda.synchronize()
        dx_equal = torch.equal(bits(got[0]), bits(plain[0])) and got[0].stride() == x.stride()
        same_bits = same_bits and all(torch.equal(bits(a), bits(b)) for a, b in zip(got, got2))
        del got2, plain
        sums_err, sums_within = k7_sums_error(x, dy, got, *args, bn_stats.SUM_RTOL)
        del got
        torch.cuda.empty_cache()
        reps = 20 if x.numel() > 1 << 24 else 50
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, mean, var, gamma, beta)]

        def plain_backward():
            torch.autograd.grad(bn_leaky.bn_leaky_plain(*leaves, eps, slope), leaves, dy)

        ms = cuda_ms(lambda: forward(x, args), reps)
        dx_ms = cuda_ms(lambda: bn_leaky.bn_leaky_dx(x, dy, *args), reps)
        device_us, dx_device_us = one_launch_each(x, dy, args)
        nbytes = x.numel() * x.element_size()
        bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        dx_bound_ms = 3 * nbytes / HBM_BYTES_PER_S * 1e3
        row = dict(shape=list(shape), dtype="bfloat16", memory="channels_last", tails=count,
                   plan=list(bn_leaky._plan(True, batch, c, hw * hw,
                                            bn_leaky._vector(x, (x,), True, c, hw * hw), 2)),
                   equal=fwd_equal and dx_equal and same_bits and sums_within,
                   forward_equal=fwd_equal, dx_equal=dx_equal,
                   bit_identical_relaunch=same_bits, sums_within=sums_within,
                   max_abs_err=sums_err, ms=ms, device_us=device_us,
                   host_us=host_us(lambda: forward(x, args), reps),
                   plain_ms=cuda_ms(lambda: bn_leaky.bn_leaky_plain(x, *args), 5),
                   bound_ms=bound_ms, bound_by="bytes", bytes=2 * nbytes,
                   share_of_bound=bound_ms * 1e3 / device_us, backward_ms=dx_ms,
                   backward_device_us=dx_device_us,
                   backward_host_us=host_us(lambda: bn_leaky.bn_leaky_dx(x, dy, *args), reps),
                   backward_plain_ms=cuda_ms(plain_backward, 5), backward_bound_ms=dx_bound_ms,
                   backward_share_of_bound=dx_bound_ms * 1e3 / dx_device_us)
        log(f"K7 bn_leaky {json.dumps(row)}")
        if not row["equal"]:
            raise AssertionError(f"K7 disagrees at {shape}: {row}")
        rows.append(row)
        del x, dy, leaves
        torch.cuda.empty_cache()
    sums = {k: sum(r["tails"] * r[k] for r in rows)
            for k in ("device_us", "bound_ms", "plain_ms", "backward_device_us",
                      "backward_bound_ms", "backward_plain_ms")}
    sums.update(model=model, batch=batch, tails=sum(r["tails"] for r in rows),
                share_of_bound=sums["bound_ms"] * 1e3 / sums["device_us"],
                backward_share_of_bound=sums["backward_bound_ms"] * 1e3
                / sums["backward_device_us"])
    log(f"K7 bn_leaky {model} B={batch} every tail {json.dumps(sums)}")
    return rows, sums


def k8_forward(bias_act, what, call, tails):
    """One main-path call (a served predictor, a loaded program) after a
    warm-up, K8's counts set to 0 just before it and read just after: every
    fp tail ``"fused"`` (``bias_act.tails``) and one launch each, ``tails``
    of them → {fused, tails, launches}."""
    call()
    torch.cuda.synchronize()
    bias_act.bias_act.tails.clear()
    bias_act.bias_act.launches = 0
    call()
    torch.cuda.synchronize()
    row = dict(fused=bias_act.bias_act.tails["fused"], tails=tails,
               launches=bias_act.bias_act.launches)
    log(f"K8 {what}: conv tails fused {row['fused']} of {tails} a batch "
        f"({dict(bias_act.bias_act.tails)}, {row['launches']} launches)")
    if dict(bias_act.bias_act.tails) != {"fused": tails} or row["launches"] != tails:
        raise AssertionError(f"K8: {what} ran {dict(bias_act.bias_act.tails)} of its {tails} "
                             f"fp tails, {row['launches']} launches")
    return row


def phase_k8(bias_act):
    """K8 at each distinct fp tail of the two bf16 serving cells
    (``kernel_times.K8_TAILS``: YOLOv3-416's leaky and linear tails, at B=8,
    and YOLOv4-608's Mish, leaky and linear tails, at B=4), bf16 in
    channels-last memory with a bf16 bias, as the bf16 predictor holds it,
    under ``inference_mode``, as the predictors call it: y bit-equal to
    ``bias_act_plain`` evaluated on the card and in x's memory format, one
    device kernel a call named for its activation (profiler). Each row:
    event-loop ms, device µs, the bytes bound (x read, y written) and its
    share, the plain expression's ms, and the host's µs a call through the
    wrapper (``bias_act.bias_act``: the op) and through the plain
    expression. The served predictors' tails through K8 are counted by
    ``k8_forward`` (phases 5 and 25b) → rows."""
    from yolov3_tpu_torch.ops.cuda.kernel_times import K8_TAILS

    rows = []
    for (model, _, tails), batch in zip(K8_TAILS, (8, 4)):
        for (activation, c, hw), count in tails.items():
            shape = (batch, c, hw, hw)
            gen = torch.Generator(device="cuda").manual_seed(c * hw)
            x = (torch.randn(shape, generator=gen, device="cuda") * 2.0).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            bias = (torch.rand(c, generator=gen, device="cuda") * 4.0 - 2.0).to(torch.bfloat16)

            def call():
                with torch.inference_mode():
                    return bias_act.bias_act(x, bias, activation)

            def plain():
                with torch.inference_mode():
                    return bias_act.bias_act_plain(x, bias, activation)

            y, want = call(), plain()
            equal = (torch.equal(y.view(torch.int16), want.view(torch.int16))
                     and y.stride() == x.stride())
            del y, want
            profiled = device_time_by_kernel(call)
            names = [] if profiled is None else [n for n, _ in profiled[5]]
            if profiled is not None and (len(names) != 1
                                         or f"bias_act_{activation}_kernel" not in names[0]):
                raise AssertionError(f"K8: expected one launch of bias_act_{activation}_kernel, "
                                     f"saw {names}")
            device_us = None if profiled is None else profiled[5][0][1] * 1e3
            bound_ms = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            row = dict(model=model, activation=activation, shape=list(shape), dtype="bfloat16",
                       memory="channels_last", tails=count, equal=equal, max_abs_err=0.0,
                       ms=cuda_ms(call, 20), device_us=device_us, host_us=host_us(call, 20),
                       plain_ms=cuda_ms(plain, 5), plain_host_us=host_us(plain, 20),
                       bound_ms=bound_ms, bound_by="bytes",
                       share_of_bound=None if device_us is None else bound_ms * 1e3 / device_us)
            log(f"K8 bias_act {json.dumps(row)}")
            if not equal:
                raise AssertionError(f"K8 disagrees at {activation} {shape}: {row}")
            rows.append(row)
            del x
        torch.cuda.empty_cache()
    return rows


def seeded_labels(rng, b, nclasses, boxes=4, max_bboxes=100):
    labels = np.zeros((b, max_bboxes, 6), np.float32)
    for i in range(b):
        for m in range(boxes):
            x0, y0 = rng.rand(2) * 0.6
            bw, bh = rng.rand(2) * 0.3 + 0.05
            labels[i, m] = [x0, y0, x0 + bw, y0 + bh, 1, rng.randint(nclasses)]
    return labels


def toy_training_files():
    return dict(model=os.path.join(ROOT, "config/models/yolov3/model.yaml"),
                names=os.path.join(ROOT, "datasets/shapes_toy/class.names"),
                anchors=os.path.join(ROOT, "datasets/shapes_toy/anchors/anchors.txt"),
                train=os.path.join(ROOT, "datasets/shapes_toy/tfrecords/train"),
                valid=os.path.join(ROOT, "datasets/shapes_toy/tfrecords/val"))


def tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def phase_train_step_vs_cpu(models, bn_stats, bodies):
    """One training forward and backward of YOLOv3-416 (3 classes) at B=2 in
    fp32 without TF32, on the card (K5's kernels) and on the CPU (K5's plain
    version) from the same seeded weights, images and labels, and a float64
    reference on the CPU whose BatchNorm moments are plain autograd.

    Tolerances: targets bit-equal; each of the 12 loss terms 1e-4 relative
    (floor: 10 absolute · 1e-4); new BN state 1e-4 · max(1, |value|). The
    gradients of this seeded initialization at B=2 are ill-conditioned in
    fp32 whoever computes them (BatchNorm's backward subtracts a mean and a
    projection that nearly cancel the incoming gradient, through 72 layers):
    single leaves of the CPU's own fp32 gradient sit tens of percent of the
    leaf's largest entry away from float64. So card and CPU are each held
    against float64, per leaf as max |g − g64| / max |g64|, and the card may be
    at most twice as far as the CPU in the worst leaf and in the median leaf.
    The largest card-vs-CPU differences are printed."""
    from yolov3_tpu_torch.config import get_anchors, read_class_names
    from yolov3_tpu_torch.models import layers
    from yolov3_tpu_torch.models.network import head_grid_sizes, to_device
    from yolov3_tpu_torch.ops.assign import assign_targets
    from yolov3_tpu_torch.parallel.train_step import loss_and_grads

    files = toy_training_files()
    nc = len(read_class_names(files["names"]))
    anchors = get_anchors(files["anchors"])
    spec = models.parse_model_config(files["model"], nc)
    params, state = models.init_model(spec, torch.Generator().manual_seed(0))
    grids = head_grid_sizes(spec, 416)
    images = torch.from_numpy(smoke_images(bodies, 2))
    labels = torch.from_numpy(seeded_labels(np.random.RandomState(0), 2, nc))

    def run(dev, dtype=torch.float32):
        bn_stats.bn_sums.launches = bn_stats.bn_moments_dx.launches = 0
        t0 = time.perf_counter()
        p, st = to_device(params, dev, dtype), to_device(state, dev, dtype)
        targets = assign_targets(labels.to(dev), anchors, grids)
        grads, new_bn, metrics = loss_and_grads(spec, p, st, images.to(dev, dtype),
                                                labels.to(dev), anchors, grids, 2)
        if dev == "cuda":
            torch.cuda.synchronize()
        return dict(targets=[t.cpu() for t in targets],
                    grads=dict(tree_paths(to_device(grads, "cpu", torch.float64))),
                    bn=to_device(new_bn, "cpu"), metrics=to_device(metrics, "cpu"),
                    launches=[bn_stats.bn_sums.launches, bn_stats.bn_moments_dx.launches],
                    seconds=time.perf_counter() - t0)

    def autograd_moments(x):  # the reference's BatchNorm statistics: no kernel, no custom backward
        mean = x.mean(dim=(0, 2, 3))
        return mean, torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)

    g, c = run("cuda"), run("cpu")
    kernel_moments = layers.bn_moments
    layers.bn_moments = autograd_moments
    try:
        ref = run("cpu", torch.float64)
    finally:
        layers.bn_moments = kernel_moments

    # which memory format the BN inputs have on the card
    formats = {}
    models.apply_model(
        spec, to_device(params, "cuda"), to_device(state, "cuda"), images.cuda(), train=True,
        out_observer=lambda sm, key, x: formats.__setitem__(
            (sm, key), "channels_last" if x.dim() == 4 and x.is_contiguous(
                memory_format=torch.channels_last) and not x.is_contiguous()
            else "nchw" if x.dim() == 4 and x.is_contiguous() else "other"))
    kinds = {}
    for v in formats.values():
        kinds[v] = kinds.get(v, 0) + 1

    targets_equal = all(torch.equal(a, b) for a, b in zip(g["targets"], c["targets"]))
    assigned = int(sum(t[..., 4].sum() for t in g["targets"]))
    terms_g, terms_c = g["metrics"]["per_grid_per_source"], c["metrics"]["per_grid_per_source"]
    term_err = float(((terms_g - terms_c).abs() / terms_c.abs().clamp(min=10.0)).max())
    bn_err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                 for (_, a), (_, b) in zip(tree_paths(g["bn"]), tree_paths(c["bn"])))

    def leaf_errors(got, want):
        return sorted(((float((got[k] - want[k]).abs().max())
                        / max(float(want[k].abs().max()), 1e-12), k) for k in want),
                      reverse=True)

    card64, cpu64 = leaf_errors(g["grads"], ref["grads"]), leaf_errors(c["grads"], ref["grads"])
    card_cpu = leaf_errors(g["grads"], c["grads"])
    median = lambda errs: errs[len(errs) // 2][0]  # noqa: E731
    finite = all(bool(torch.isfinite(a).all()) for a in g["grads"].values())
    row = dict(batch=2, targets_equal=targets_equal, boxes_assigned=assigned,
               total_loss_card=float(g["metrics"]["total_loss"]),
               total_loss_cpu=float(c["metrics"]["total_loss"]),
               loss_terms_max_rel_err=term_err, bn_state_max_rel_err=bn_err,
               grad_leaves=len(card64),
               grad_err_vs_float64=dict(card_worst=card64[0][0], cpu_worst=cpu64[0][0],
                                        card_median=median(card64), cpu_median=median(cpu64),
                                        card_worst_leaves=[[k, e] for e, k in card64[:3]],
                                        cpu_worst_leaves=[[k, e] for e, k in cpu64[:3]]),
               grad_card_vs_cpu=dict(worst=card_cpu[0][0], median=median(card_cpu),
                                     worst_leaves=[[k, e] for e, k in card_cpu[:3]]),
               k5_launches_forward_backward=g["launches"],
               bn_input_memory_formats=kinds,
               seconds_card=g["seconds"], seconds_cpu=c["seconds"],
               seconds_cpu_float64=ref["seconds"])
    log(f"train step YOLOv3-416 card vs CPU {json.dumps(row)}")
    if not (targets_equal and finite and assigned > 0 and term_err <= 1e-4 and bn_err <= 1e-4
            and card64[0][0] <= max(2 * cpu64[0][0], 1e-3)
            and median(card64) <= max(2 * median(cpu64), 1e-4)):
        raise AssertionError(f"one training step: the card disagrees with the CPU: {row}")
    if g["launches"] != [72, 72] or c["launches"] != [0, 0]:
        raise AssertionError(f"K5 launches over one step: card {g['launches']}, "
                             f"CPU {c['launches']}, expected 72 + 72 and none")
    row["main_memory_format"] = max(kinds, key=kinds.get)
    return row


class _LogLines(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


TRAINER_EPOCHS = 3  # phase 15: 2 steps an epoch


def phase_trainer(inference_app, bn_stats, bn_leaky, bodies, smi):
    """The trainer through ``Train`` on the card: YOLOv3 (full Darknet-53) at
    416², B=16, the shapes_toy TFRecords (32 training images: 2 steps an
    epoch), Adam at 1e-3, EMA, ``TRAINER_EPOCHS`` epochs, once in fp32 and once with
    ``mixed_precision``; then one more epoch with ``resume``; then the serving
    predictor on the trained checkpoint. K5's and K7's counts are set to 0
    just before each tier's first ``Train`` call and read just after:
    72 launches a step each way, each kernel's."""
    import re

    from yolov3_tpu_torch.apps.train_app import Train
    from yolov3_tpu_torch.config import get_anchors, read_class_names
    from yolov3_tpu_torch.models import parse_model_config
    from yolov3_tpu_torch.models.network import head_grid_sizes
    from yolov3_tpu_torch.parallel.train_step import make_adam, make_train_step

    files = toy_training_files()
    out_dir = os.path.join(ROOT, "build", "smoke_train")
    handler = _LogLines()
    logging.getLogger().addHandler(handler)
    rows, total_launches, k7_launches = [], [0, 0], [0, 0]
    try:
        for tier, mixed in (("fp32", False), ("bf16", True)):
            ckpt = os.path.join(out_dir, tier, "yolov3_toy.tf")
            for suffix in (".npz", ".train_state.npz", ".ema.npz"):
                if os.path.exists(ckpt + suffix):
                    os.remove(ckpt + suffix)
            config = dict(
                model_config_file=files["model"], image_size=416, batch_size=16,
                max_bboxes=100, debug_mode=False, anchors_file=files["anchors"],
                learning_rate=0.001, early_stop_patience=13, epochs=TRAINER_EPOCHS,
                training_mode="fit",
                render_dataset_example=False, max_dataset_examples=None,
                transfer_learning_config={"transfer_list": ["none"]},
                dataset_config={"input_data_source": "tfrecords",
                                "tfrecords": {"train": files["train"], "valid": files["valid"]}},
                classes_name_file=files["names"], output_checkpoints_path=ckpt,
                early_stopping=False, weights_save_peroid=5, resume=False,
                mixed_precision=mixed, ema=True, seed=0)
            handler.lines.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            bn_stats.bn_sums.launches = bn_stats.bn_moments_dx.launches = 0
            bn_leaky.bn_leaky.launches = bn_leaky.bn_leaky_dx.launches = 0
            t0 = time.monotonic()
            train_state = Train()(**config)
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            launches = [bn_stats.bn_sums.launches, bn_stats.bn_moments_dx.launches]
            k7 = [bn_leaky.bn_leaky.launches, bn_leaky.bn_leaky_dx.launches]
            peak = torch.cuda.max_memory_allocated()
            text = "\n".join(handler.lines)
            losses = [float(v) for v in re.findall(r"epoch \d+: train_loss (\S+)", text)]
            val = [float(v) for v in re.findall(r"epoch \d+: val_loss (\S+)", text)]
            steps = sum(int(v) for v in re.findall(r"epoch \d+: (\d+) steps in", text))
            rates = [float(v) for v in re.findall(r"steps in \S+ \((\S+) img/s\)", text)]
            written = [os.path.exists(ckpt + sfx) for sfx in (".npz", ".train_state.npz",
                                                              ".ema.npz")]
            step_count = int(train_state["step"])

            # a second call with resume and one more epoch
            handler.lines.clear()
            Train()(**dict(config, resume=True, epochs=TRAINER_EPOCHS + 1))
            resumed = [ln for ln in handler.lines if "resumed full train state" in ln]
            resumed_epochs = re.findall(r"epoch (\d+): train_loss", "\n".join(handler.lines))

            # the serving predictor on the trained checkpoint
            predictor, names, _ = inference_app.build_serving_predictor(
                files["model"], files["names"], files["anchors"], ckpt, 416,
                nms_score_threshold=0.1, compute_precision="bf16" if mixed else None)
            boxes, _, scores, selected, num_valid = predictor(smoke_images(bodies, 16))
            torch.cuda.synchronize()
            # 6 steps at BatchNorm momentum 0.99 leave the running statistics
            # near their initial values, so the served heads are far off and
            # exp(wh) may overflow: held are the answer's shapes and its scores
            served_ok = (tuple(selected.shape) == (16, 100) and len(names) == 3
                         and tuple(boxes.shape)[0] == 16 and boxes.shape[-1] == 4
                         and bool(torch.isfinite(scores).all())
                         and bool(((scores >= 0) & (scores <= 1)).all())
                         and bool(((num_valid >= 0) & (num_valid <= 100)).all()))
            boxes_finite = bool(torch.isfinite(boxes).all())
            overflow = served_head_overflow(files, ckpt, torch.from_numpy(smoke_images(bodies, 16)),
                                            torch.bfloat16 if mixed else None)

            # steady state of the step itself, on one resident batch: host
            # clock around 5 steps ending in a synchronize, then one step
            # under the profiler for K5's share of the device time
            nc = len(read_class_names(files["names"]))
            spec = parse_model_config(files["model"], nc)
            optimizer = make_adam(0.001)
            step = make_train_step(spec, get_anchors(files["anchors"]),
                                   head_grid_sizes(spec, 416), 16, optimizer,
                                   compute_dtype=torch.bfloat16 if mixed else None,
                                   ema_decay=0.9999)
            images = torch.from_numpy(smoke_images(bodies, 16)).cuda()
            labels = torch.from_numpy(seeded_labels(np.random.RandomState(1), 16, nc)).cuda()
            state = [train_state]

            def one_step():
                state[0], _ = step(state[0], images, labels)

            one_step()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(5):
                one_step()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t1) * 1e3 / 5
            profiled = device_time_by_kernel(one_step)
            if profiled is None:
                share = "not measured (the profiler showed no device time)"
            else:
                total, by_name, count, host_ms, _, in_order = profiled
                pick = lambda key: sum(ms for n, ms in by_name.items() if key in n)  # noqa: E731
                k5_fwd, k5_bwd = pick("bn_moments_"), pick("bn_dx_kernel")
                k5_device_launches = sum("bn_moments_" in n or "bn_dx_kernel" in n
                                         for n, _ in in_order)
                k7_fwd, k7_bwd = pick("bn_leaky_fwd_"), pick("bn_leaky_bwd_")
                k7_device_launches = sum("bn_leaky_" in n for n, _ in in_order)
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
                share = dict(device_busy_ms=total, k5_forward_ms=k5_fwd, k5_backward_ms=k5_bwd,
                             k5_share=(k5_fwd + k5_bwd) / total, device_launches=count,
                             k5_device_launches=k5_device_launches, k7_forward_ms=k7_fwd,
                             k7_backward_ms=k7_bwd, k7_share=(k7_fwd + k7_bwd) / total,
                             k7_device_launches=k7_device_launches,
                             host_enqueue_ms=host_ms, top=[[n[:60], ms] for n, ms in top])
            del state, train_state, predictor
            row = dict(tier=tier, card=smi, epochs=TRAINER_EPOCHS, steps=steps, batch=16,
                       image_size=416,
                       train_loss_first=losses[0] if losses else None,
                       train_loss_last=losses[-1] if losses else None, train_losses=losses,
                       val_loss_first=val[0] if val else None,
                       val_loss_last=val[-1] if val else None,
                       train_call_seconds=seconds,
                       epoch_img_per_s_last=rates[-1] if rates else None,
                       step_ms=step_ms, img_per_s=16 / step_ms * 1e3,
                       max_memory_allocated_gb=peak / 1e9, k5_launches=launches,
                       k7_launches=k7, checkpoints_written=written, step_counter=step_count,
                       resumed=resumed[:1], resumed_epochs=resumed_epochs,
                       served_detections=int(num_valid.sum()), served_boxes_finite=boxes_finite,
                       served_head_overflow=overflow, profile=share)
            log(f"trainer YOLOv3-416 {json.dumps(row)}")
            ok = (len(losses) == len(val) == TRAINER_EPOCHS and all(np.isfinite(losses + val))
                  and losses[-1] < losses[0] and steps == step_count == 2 * TRAINER_EPOCHS
                  and launches == [72 * steps, 72 * steps] and k7 == launches and all(written)
                  and len(resumed) == 1 and f"at epoch {TRAINER_EPOCHS + 1}" in resumed[0]
                  and resumed_epochs == [str(TRAINER_EPOCHS + 1)] and served_ok)
            if isinstance(share, dict) and (share["k5_device_launches"] != 144
                                            or share["k7_device_launches"] != 144):
                ok = False  # one launch forward and one backward for each of the 72 layers
            if not ok:
                raise AssertionError(f"the trainer's run failed its checks: {row}")
            total_launches[0] += launches[0]
            total_launches[1] += launches[1]
            k7_launches[0] += k7[0]
            k7_launches[1] += k7[1]
            rows.append(row)
    finally:
        logging.getLogger().removeHandler(handler)
    return rows, total_launches, k7_launches


# --- the offline entry points: evaluation, the int8 gate, batch inference ---

EVAL_SWEEP = [0.004, 0.1, 0.2, 0.5, 0.9]  # config/evaluate_config.yaml
TOY_TFRECORDS = os.path.join(ROOT, "datasets/shapes_toy/tfrecords")
# YOLOv3-416 for the 3 shapes_toy classes with seeded weights, written by
# phase 17 (the repo has no trained full-width weights)
SEEDED_YOLOV3 = os.path.join(ROOT, "build", "smoke_eval", "yolov3", "yolov3_seeded.tf")


def seeded_yolov3_config(**overrides):
    """detect_config.yaml keys for the seeded YOLOv3-416 (COCO anchors)."""
    return tiny_detect_config(
        model_config_file=os.path.join(ROOT, "config/models/yolov3/model.yaml"),
        input_weights_path=SEEDED_YOLOV3,
        anchors_file=os.path.join(ROOT, "datasets/coco2012/anchors.txt"), **overrides)


def tiny_detect_config(**overrides):
    """detect_config.yaml keys for the trained YOLOv3-tiny at 416, absolute
    paths."""
    cfg = dict(model_config_file=os.path.join(ROOT, "config/models/yolov3_tiny/model.yaml"),
               classes_name_file=os.path.join(ROOT, "datasets/shapes_toy/class.names"),
               anchors_file=os.path.join(ROOT, "datasets/shapes_toy/anchors/anchors_tiny.txt"),
               input_weights_path=os.path.join(ROOT, "checkpoints/output/yolov3_train_tiny.tf"),
               image_size=416, batch_size=8, yolo_max_boxes=100, nms_iou_threshold=0.5,
               nms_score_threshold=0.1, input_data_source="tfrecords",
               tfrecords_dir=os.path.join(TOY_TFRECORDS, "test"), images_dir=CALIBRATION_DIR,
               image_file_path=None, bbox_color=[1.0, 1.0, 1.0], font_size=15)
    cfg.update(overrides)
    return cfg


class _ThresholdMarks:
    """The standard output of a run, written through to a file. At each
    "Results Bbox and Classes:" line, which ``evaluate`` prints once a
    threshold's batches are done, it notes the launch count of each kernel
    wrapper in ``counted``."""

    def __init__(self, file, counted):
        self.file, self.counted, self.marks = file, counted, []

    def write(self, text):
        if text.startswith("Results Bbox and Classes:"):
            self.marks.append({k: w.launches for k, w in self.counted.items()})
        return self.file.write(text)

    def flush(self):
        self.file.flush()


def per_threshold(marks):
    """Launches of each threshold from the cumulative counts at its marks
    (the counts set to 0 before the run)."""
    rows, last = [], {}
    for mark in marks:
        rows.append({k: v - last.get(k, 0) for k, v in mark.items()})
        last = mark
    return rows


def quietly(work_dir, fn, *args, counted=None, **kwargs):
    """Run ``fn`` with ``work_dir`` as the working directory (the evaluation
    writes its .npy histograms there) and its printing sent to
    ``work_dir/stdout.txt``; → (result, the INFO log lines it emitted,
    seconds, the card synchronised; the launch counts of ``counted`` at each
    threshold, ``_ThresholdMarks``)."""
    import contextlib

    os.makedirs(work_dir, exist_ok=True)
    handler = _LogLines()
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    cwd = os.getcwd()
    os.chdir(work_dir)
    t0 = time.monotonic()
    try:
        with open("stdout.txt", "w") as f:
            out = _ThresholdMarks(f, counted or {})
            with contextlib.redirect_stdout(out):
                result = fn(*args, **kwargs)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        root.removeHandler(handler)
        root.setLevel(level)
    return result, handler.lines, time.monotonic() - t0, out.marks


def escalations(lines, thr):
    """The K values the evaluation escalated to at score threshold ``thr``."""
    import re

    return [int(re.search(r"K=(\d+)", line).group(1)) for line in lines
            if line.startswith("NMS top-K escalation") and f"score_threshold={thr} (" in line]


def tiny_model():
    """(spec, params, bn_state, anchors) of the trained tiny, on the CPU."""
    from yolov3_tpu_torch import models
    from yolov3_tpu_torch.config import get_anchors
    from yolov3_tpu_torch.io.resolve import load_weights

    cfg = tiny_detect_config()
    spec = models.parse_model_config(cfg["model_config_file"], 3)
    params, state = load_weights(spec, *models.init_model(spec, torch.Generator().manual_seed(0)),
                                 cfg["input_weights_path"])
    return spec, params, state, get_anchors(cfg["anchors_file"])


def tiny_heads(model, images, device):
    """The BN-folded fp32 heads of ``model`` (``tiny_model()``) on ``device``."""
    from yolov3_tpu_torch import models
    from yolov3_tpu_torch.models.network import to_device

    spec, params, state, _ = model
    folded = to_device(models.fold_batch_norm(params, state), device)
    with torch.inference_mode():
        return models.apply_model(spec, folded, {}, torch.from_numpy(images).to(device))


def tiny_decoded(images, device):
    """The trained tiny's decoded (boxes, scores) on ``device``, on the CPU."""
    from yolov3_tpu_torch.ops.decode import yolo_decode

    model = tiny_model()
    with torch.inference_mode():
        boxes, conf, probs = yolo_decode(tiny_heads(model, images, device), model[3], 3)
        return boxes.cpu(), (conf[..., 0] * probs.amax(-1)).cpu()


def differing_images(dir_a, dir_b, thr):
    """Images whose per-image histograms differ between two evaluation runs."""
    rows = None
    for name in ("preds", "gts", "tp", "fp", "fn"):
        a, b = (np.load(os.path.join(d, f"{name}_{thr}.npy")) for d in (dir_a, dir_b))
        if a.shape != b.shape:
            raise AssertionError(f"{name}_{thr}.npy: shapes {a.shape} and {b.shape}")
        diff = (a != b).any(axis=1)
        rows = diff if rows is None else rows | diff
    return np.nonzero(rows)[0].tolist()


def corner_case_batch():
    """Padded predictions and gts holding the matcher's corner cases: two
    predictions on one gt, a negative gt class, an image with no valid gt, an
    inf and a NaN box, identical gts of different classes (an argmax tie),
    a class id out of range."""
    rng = np.random.default_rng(7)
    b, p, g = 4, 10, 5
    xy = rng.uniform(0.0, 0.7, (b, g + p, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (b, g + p, 2))], -1)
    gt_boxes, pred_boxes = boxes[:, :g].astype(np.float32), boxes[:, g:].astype(np.float32)
    pred_boxes[:, :g] = gt_boxes + rng.normal(0, 0.02, gt_boxes.shape).astype(np.float32)
    gt_classes = rng.integers(0, 3, (b, g)).astype(np.int32)
    pred_classes = rng.integers(0, 3, (b, p)).astype(np.int32)
    pred_classes[:, :g] = gt_classes
    gt_valid, pred_valid = np.ones((b, g), bool), np.ones((b, p), bool)
    pred_boxes[0, 5] = pred_boxes[0, 6] = gt_boxes[0, 0]
    pred_classes[0, 5] = pred_classes[0, 6] = gt_classes[0, 0]
    gt_classes[1, 2] = -1
    gt_valid[2] = False
    pred_boxes[3, 0] = [0.1, 0.1, np.inf, 0.5]
    pred_boxes[3, 1] = [np.nan, 0.2, 0.4, 0.4]
    gt_boxes[3, 1] = gt_boxes[3, 0]
    gt_classes[3, 0], gt_classes[3, 1] = 1, 2
    pred_boxes[3, 2] = gt_boxes[3, 0]
    pred_classes[3, 2], pred_classes[3, 3] = 2, 9
    return pred_boxes, pred_classes, pred_valid, gt_boxes, gt_classes, gt_valid


def phase_eval_tiny(evaluate_app, nms_mod, nms_kernel, round_sweep):
    """``evaluate`` on the trained YOLOv3-tiny at 416 over shapes_toy
    ``tfrecords/val`` (16 images, batch 8), the reference sweep, on the card
    and on the CPU.

    Per threshold the counters of card and CPU must be equal, or each image
    whose histograms differ must show a near-tie witness within ``NEAR_TIE``:
    a decision of greedy NMS that flips between the two devices' decoded
    outputs (``near_tie_witness``), or a detection–gt IoU that close to the
    evaluation's 0.5. At 0.004 the exact-K policy must escalate to K = N =
    2,535 on the card, in one step (the round-sweep kernel, K2); the CPU
    doubles. K1 and K2 must launch in the card's run. Then the matcher
    alone: on the card's own padded detections of one batch, and on a batch
    of corner cases (argmax ties, NaN and inf boxes, no valid gt), the
    card's counters bit-equal to the CPU's."""
    from yolov3_tpu_torch.data.tfrecord import parse_tfrecords
    from yolov3_tpu_torch.eval import detections_evaluator as ev

    cfg = tiny_detect_config(tfrecords_dir=os.path.join(TOY_TFRECORDS, "val"))
    work = os.path.join(ROOT, "build", "smoke_eval", "tiny")
    counted = {"nms_sweep": nms_kernel.suppression_sweep, "round_sweep": round_sweep.round_sweep}
    runs = {}
    for dev in ("cuda", "cpu"):
        for wrapper in counted.values():
            wrapper.launches = 0
        runs[dev] = quietly(os.path.join(work, dev), evaluate_app.evaluate,
                            {"evaluate_nms_score_thresholds": EVAL_SWEEP}, cfg, device=dev,
                            counted=counted)
        if dev == "cuda":
            launches = {k: wrapper.launches for k, wrapper in counted.items()}
    card_launches = per_threshold(runs["cuda"][3])
    examples = list(parse_tfrecords(cfg["tfrecords_dir"], 416, 100, cfg["classes_name_file"]))
    images = np.stack([im for im, _ in examples]).astype(np.float32)
    labels = np.stack([lb for _, lb in examples])

    decoded, rows, unexplained = None, [], []
    for i, thr in enumerate(EVAL_SWEEP):
        card, cpu = runs["cuda"][0][i], runs["cpu"][0][i]
        witnesses = []
        for image in differing_images(os.path.join(work, "cuda"), os.path.join(work, "cpu"), thr):
            if decoded is None:
                decoded = {dev: tiny_decoded(images, dev) for dev in ("cuda", "cpu")}
            (gb, gs), (cb, cs) = decoded["cuda"], decoded["cpu"]
            witness = near_tie_witness(nms_mod, gb[image], gs[image], cb[image], cs[image],
                                       dict(score_threshold=thr, iou_threshold=IOU_THR))
            gt = torch.from_numpy(labels[image][labels[image][:, 4] != 0][:, :4])[None]
            keep = (cs[image] > thr).nonzero()[:, 0]
            iou = ev._pairwise_iou(cb[image][keep][None], gt)
            witness["eval_iou_near_0.5"] = iou[(iou - 0.5).abs() <= NEAR_TIE].tolist()
            witnesses.append(dict(image=image, **witness))
            if not witness["eval_iou_near_0.5"] and (witness["margin"] is None
                                                     or witness["margin"] > NEAR_TIE):
                unexplained.append((thr, image))
        rows.append(dict(score_threshold=thr, map50_card=card["map50"], map50_cpu=cpu["map50"],
                         images_per_sec_card=card["images_per_sec"],
                         images_per_sec_cpu=cpu["images_per_sec"],
                         k_card=escalations(runs["cuda"][1], thr),
                         k_cpu=escalations(runs["cpu"][1], thr), launches_card=card_launches[i],
                         counters_equal=card["counters"] == cpu["counters"]
                         and card["counters_oneclass"] == cpu["counters_oneclass"],
                         images_differing=witnesses))
        log(f"eval tiny 416 {json.dumps(rows[-1])}")

    # the matcher alone, on the card's own padded detections and on corner cases
    predict = evaluate_app.make_sweepable_predictor(*tiny_model(), 3, 100, device="cuda")
    out = predict(images[:8], IOU_THR, 0.1, num_candidates=10**6)
    pb, pc, _, pv = evaluate_app._selected_to_padded(*out, 100)
    lab = torch.from_numpy(labels[:8]).cuda()
    batches = [(pb, pc, pv, lab[..., :4], lab[..., 5].int(), lab[..., 4] != 0),
               tuple(torch.from_numpy(a).cuda() for a in corner_case_batch())]
    matcher_equal = []
    for batch in batches:
        on_card = ev.evaluate_image_counters(*batch, 3, 0.5)
        on_cpu = ev.evaluate_image_counters(*(t.cpu() for t in batch), 3, 0.5)
        matcher_equal.append(all(torch.equal(on_card[k].cpu(), on_cpu[k]) for k in on_cpu))
    k_first = rows[0]["k_card"]
    summary = dict(launches=launches, matcher_bit_equal=matcher_equal,
                   seconds_card=runs["cuda"][2], seconds_cpu=runs["cpu"][2])
    log(f"eval tiny 416 {json.dumps(summary)}")
    if unexplained or not all(matcher_equal) or k_first != [2535] or min(launches.values()) == 0:
        raise AssertionError(f"eval tiny: unexplained {unexplained}, matcher {matcher_equal}, "
                             f"escalation at 0.004 {k_first}, launches {launches}")
    return rows, launches



def phase_eval_full(evaluate_app, models, nms_kernel, round_sweep):
    """``evaluate`` at full width on the card: YOLOv3-416 (Darknet-53, 3
    heads) for the 3 shapes_toy classes with the COCO anchors, seeded weights
    written by ``save_weights`` (the repo has no trained full-width weights,
    so its mAP means nothing), batch 16 over ``tfrecords/train`` (32 images).
    One evaluation of the sweep: per threshold img/s, the largest K reached
    and K1's and K2's launches (read at the line the threshold's results
    start with, ``_ThresholdMarks``)."""
    from yolov3_tpu_torch.io.resolve import save_weights
    from yolov3_tpu_torch.ops.nms import DEFAULT_NUM_CANDIDATES

    work = os.path.dirname(SEEDED_YOLOV3)
    os.makedirs(work, exist_ok=True)
    cfg = seeded_yolov3_config(batch_size=16, tfrecords_dir=os.path.join(TOY_TFRECORDS, "train"))
    spec = models.parse_model_config(cfg["model_config_file"], 3)
    save_weights(spec, *models.init_model(spec, torch.Generator().manual_seed(0)), SEEDED_YOLOV3)
    counted = {"nms_sweep": nms_kernel.suppression_sweep, "round_sweep": round_sweep.round_sweep}
    for wrapper in counted.values():
        wrapper.launches = 0
    results, lines, seconds, marks = quietly(
        work, evaluate_app.evaluate, {"evaluate_nms_score_thresholds": EVAL_SWEEP}, cfg,
        device="cuda", counted=counted)
    total = {k: wrapper.launches for k, wrapper in counted.items()}
    rows = []
    for thr, result, launches in zip(EVAL_SWEEP, results, per_threshold(marks)):
        ks = escalations(lines, thr)
        row = dict(score_threshold=thr, images=result["counters"]["examples"],
                   images_per_sec=result["images_per_sec"], wall_seconds=result["wall_seconds"],
                   escalated=bool(ks), largest_k=max(ks) if ks else DEFAULT_NUM_CANDIDATES,
                   launches=launches, map50=result["map50"])
        rows.append(row)
        log(f"eval yolov3-416 seeded {json.dumps(row)}")
        if row["images"] != 32 or sum(launches.values()) == 0:
            raise AssertionError(f"full-width evaluation: {row}")
    log(f"eval yolov3-416 seeded: {seconds:.1f} s for the sweep, launches {json.dumps(total)}")
    if not any(r["escalated"] for r in rows):
        log("eval yolov3-416 seeded: no threshold escalated; the seeded weights keep 100 "
            "boxes within the top 512 (K2's full-width launch is held by phases 4 and 5)")
    return rows, total


def phase_gate(inference_app, conv1x1, conv_int8, smi):
    """The int8 accuracy gate (``tools/int8_accuracy_gate.run_gate``) on the
    card: trained tiny at 416 over shapes_toy ``tfrecords/val`` (16 images),
    bf16 against int8 calibrated on the first 4; K3 and K6 must launch. Its
    verdict is a measurement and does not fail the phase. Beside it the fp32
    tier's mAP@0.5 taken the gate's way (same images, K = 512, threshold 0.1)."""
    from yolov3_tpu_torch.data.tfrecord import parse_tfrecords
    from yolov3_tpu_torch.eval.detections_evaluator import APAccumulator
    from yolov3_tpu_torch.tools import int8_accuracy_gate as gate

    conv1x1.conv1x1_int8_requant.launches = conv_int8.conv_int8.launches = 0
    cwd = os.getcwd()
    os.chdir(ROOT)  # the gate's defaults are paths in the repo
    try:
        report = gate.run_gate(max_images=32, image_size=416, device="cuda")
    finally:
        os.chdir(cwd)
    launches = {"conv1x1_int8": conv1x1.conv1x1_int8_requant.launches,
                "conv_int8": conv_int8.conv_int8.launches}

    cfg = tiny_detect_config()
    examples = list(parse_tfrecords(os.path.join(TOY_TFRECORDS, "val"), 416, 100,
                                    cfg["classes_name_file"]))
    spec, params, state, anchors = tiny_model()
    predict = inference_app.make_predictor(spec, params, state, anchors, 3, 100, 0.5, 0.1,
                                           device="cuda")
    out = [t.cpu().numpy() for t in predict(np.stack([im for im, _ in examples]))]
    acc = APAccumulator(3)
    for i, (_, lb) in enumerate(examples):
        sel = out[3][i, : int(out[4][i])]
        gt = lb[lb[:, 4] > 0]
        acc.add_image(out[0][i][sel], out[1][i][sel], out[2][i][sel], gt[:, :4],
                      gt[:, 5].astype(np.int32))
    row = dict(report, map50_fp32=round(acc.compute()[1], 4), launches=launches, card=smi)
    log(f"int8 gate on the card {json.dumps(row)}")
    if min(launches.values()) == 0 or report["images"] != 16:
        raise AssertionError(f"int8 gate: {row}")
    return row, launches


def phase_inference(inference_app, nms_mod, nms_kernel, round_sweep, resblock, conv1x1,
                    conv_int8):
    """Batch inference through ``Inference`` on the card, outputs under
    ``build/smoke_infer/``: the trained tiny at 416 over ``tfrecords/test``
    (8 images, batch 8) in fp32 and over the 32 shapes_toy images with
    ``letterbox: true``; and ``quantize: int8_chain`` over ``tfrecords/test``
    with phase 17's seeded YOLOv3-416, calibrated on those images (the tiny
    has no residual block; Darknet-53's 23 go through K4, which must
    launch).
    The fp32 and letterbox runs against the same runs on the CPU: the same
    lines of detect.txt with the same classes, boxes 1e-3 and scores 1e-4,
    or a near-tie witness (phase 6's rule). Then ``ops/detect.detect`` on the
    test batch's heads against decode ∘ yolo_nms ∘ gather_detections on the
    card (classes and valid masks equal, boxes and scores 1e-6; K1 must
    launch) and ``ops/image`` resize and letterbox card against CPU (1e-5)."""
    from yolov3_tpu_torch.data.image import decode_image, letterbox_resize
    from yolov3_tpu_torch.data.tfrecord import parse_tfrecords
    from yolov3_tpu_torch.ops import detect, image
    from yolov3_tpu_torch.ops.decode import yolo_decode

    work = os.path.join(ROOT, "build", "smoke_infer")
    counted = {"nms_sweep": nms_kernel.suppression_sweep, "round_sweep": round_sweep.round_sweep,
               "conv1x1_int8": conv1x1.conv1x1_int8_requant, "conv_int8": conv_int8.conv_int8,
               "resblock_int8": resblock.fused_resblock}
    total = dict.fromkeys(counted, 0)
    runs, rows = {}, []
    for name, config in (
            ("fp32", tiny_detect_config()),
            ("int8_chain", seeded_yolov3_config(quantize="int8_chain")),
            ("letterbox", tiny_detect_config(input_data_source="images_dir", letterbox=True))):
        for dev in ("cuda", "cpu") if name != "int8_chain" else ("cuda",):
            for wrapper in counted.values():
                wrapper.launches = 0
            out_dir = os.path.join(work, f"{name}_{dev}")
            results, _, seconds, _ = quietly(out_dir, inference_app.Inference(),
                                          **dict(config, output_dir=out_dir, device=dev))
            with open(os.path.join(out_dir, "detect.txt")) as f:
                lines = f.read().splitlines()
            runs[name, dev] = results, lines
            if dev == "cuda":
                launches = {k: wrapper.launches for k, wrapper in counted.items()}
                for k in total:
                    total[k] += launches[k]
                rows.append(dict(run=name, images=len(lines), seconds=seconds,
                                 detections=sum(len(r[0]) for r in results),
                                 launches=launches))
                log(f"inference on the card {json.dumps(rows[-1])}")
    k4 = next(r for r in rows if r["run"] == "int8_chain")["launches"]["resblock_int8"]
    if k4 == 0 or min(r["launches"]["nms_sweep"] for r in rows) == 0:
        raise AssertionError(f"inference: a kernel of the path never launched: {rows}")

    # card against CPU, detect.txt and the returned detections
    sources = {"fp32": np.stack([im for im, _ in parse_tfrecords(
        os.path.join(TOY_TFRECORDS, "test"), 416, 100, None)]).astype(np.float32),
        "letterbox": np.stack([letterbox_resize(decode_image(open(f, "rb").read()) / 255.0,
                                                416, 416) for f in
                               sorted(glob.glob(os.path.join(CALIBRATION_DIR, "*.jpg")))
                               ]).astype(np.float32)}
    compared = {}
    for name, images in sources.items():
        (card, card_lines), (cpu, cpu_lines) = runs[name, "cuda"], runs[name, "cpu"]
        if len(card) != len(images) or len(card_lines) != len(cpu_lines) != len(images):
            raise AssertionError(f"inference {name}: {len(card)} results, lines "
                                 f"{len(card_lines)} / {len(cpu_lines)}")
        witnesses, box_err, score_err, decoded = [], 0.0, 0.0, None
        for i, ((gn, gb, gs), (cn, cb, cs)) in enumerate(zip(card, cpu)):
            if gn != cn:
                if decoded is None:
                    decoded = {dev: tiny_decoded(images, dev) for dev in ("cuda", "cpu")}
                (db, ds), (eb, es) = decoded["cuda"], decoded["cpu"]
                witnesses.append(dict(image=i, **near_tie_witness(
                    nms_mod, db[i], ds[i], eb[i], es[i],
                    dict(score_threshold=0.1, iou_threshold=IOU_THR))))
                continue
            if len(gn):
                box_err = max(box_err, float(np.abs(np.asarray(gb) - np.asarray(cb)).max()))
                score_err = max(score_err, float(np.abs(np.asarray(gs) - np.asarray(cs)).max()))
        compared[name] = dict(images_differing=witnesses, box_max_abs_err=box_err,
                              score_max_abs_err=score_err)
        unexplained = [w["image"] for w in witnesses
                       if w["margin"] is None or w["margin"] > NEAR_TIE]
        if unexplained or box_err > 1e-3 or score_err > 1e-4:
            raise AssertionError(f"inference {name}: card vs CPU {compared[name]}")

    # ops/detect on the test batch's heads against decode ∘ yolo_nms ∘ gather
    model = tiny_model()
    anchors = model[3]
    kw = dict(max_boxes=100, iou_threshold=0.5, score_threshold=0.1, num_candidates=256)
    heads = tiny_heads(model, sources["fp32"], "cuda")
    with torch.inference_mode():
        nms_kernel.suppression_sweep.launches = 0
        fused = detect.detect(heads, anchors, 3, **kw)
        torch.cuda.synchronize()
        k1_detect = nms_kernel.suppression_sweep.launches
        unfused = nms_mod.gather_detections(*nms_mod.yolo_nms(*yolo_decode(heads, anchors, 3),
                                                              **kw))
    valid = fused[3]
    detect_row = dict(
        detections=int(valid.sum()), k1_launches=k1_detect,
        valid_equal=torch.equal(valid, unfused[3]),
        classes_equal=torch.equal(fused[1][valid], unfused[1][valid]),
        box_max_abs_err=max_abs(fused[0][valid], unfused[0][valid]),
        score_max_abs_err=max_abs(fused[2][valid], unfused[2][valid]))
    total["nms_sweep"] += k1_detect

    # ops/image on the card against the CPU
    rng = np.random.default_rng(3)
    image_errs = []
    for shape, size in (((2, 256, 256, 3), (416, 416)), ((1, 333, 500, 3), (416, 416)),
                        ((3, 416, 416, 3), (207, 311))):
        x = torch.from_numpy(rng.random(shape, dtype=np.float32))
        for fn in (image.resize_bilinear, image.letterbox_resize):
            image_errs.append(max_abs(fn(x.cuda(), *size).cpu(), fn(x, *size)))
    row = dict(runs=rows, card_vs_cpu=compared, detect=detect_row,
               image_ops_max_abs_err=max(image_errs), launches=total)
    log(f"inference {json.dumps(row)}")
    if (not (detect_row["valid_equal"] and detect_row["classes_equal"]) or k1_detect == 0
            or detect_row["box_max_abs_err"] > 1e-6 or detect_row["score_max_abs_err"] > 1e-6
            or detect_row["detections"] == 0 or max(image_errs) > 1e-5):
        raise AssertionError(f"inference: {row}")
    return row, total


# --- phase 20: the trainer's extras on the card ---

EXTRAS_DIR = os.path.join(ROOT, "build", "smoke_extras")
EXP_F32_LIMIT = float(np.log(np.finfo(np.float32).max))  # exp overflows f32 above this


def k5_check(bn_stats, x, label, baseline=None):
    """K5 forward and backward on ``x`` (a phase view or a subsample copy)
    against its plain version, with phase 13's checks: sums within
    ``SUM_RTOL`` of float64, two launches bit-identical, mean and var
    bit-equal to the plain expression of the kernel's own sums, dx bit-equal
    to the plain dx. Device µs of one call (profiler), and of ``baseline``
    (the same statistics without the rewrite) when given."""
    from yolov3_tpu_torch.ops.cuda.kernel_times import device_us

    n = x.numel() // x.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(n % 100003)
    dmean = torch.randn(x.shape[1], generator=gen, device="cuda")
    dvar = torch.randn(x.shape[1], generator=gen, device="cuda")
    with torch.no_grad():
        s1, q1 = bn_stats.bn_sums(x)
        s2, q2 = bn_stats.bn_sums(x)
        mean, var = bn_stats.bn_moments(x)
    torch.cuda.synchronize()
    dims = (0, 2, 3)
    ref_s = x.sum(dim=dims, dtype=torch.float64)
    ref_abs = x.abs().sum(dim=dims, dtype=torch.float64)
    ref_q = (x.double() * x.double()).sum(dim=dims)
    err = max(float(((s1.double() - ref_s).abs() / ref_abs).max()),
              float(((q1.double() - ref_q).abs() / ref_q).max()))
    del ref_s, ref_abs, ref_q
    want_mean = s1 / n
    want_var = torch.clamp(q1 / n - want_mean * want_mean, min=0.0)
    moments_equal = torch.equal(mean, want_mean) and torch.equal(var, want_var)
    dx = bn_stats.bn_moments_dx(x, mean, dmean, dvar)
    want_dx = bn_stats.bn_moments_dx_plain(x, mean, dmean, dvar)
    dx_equal = torch.equal(dx, want_dx) and dx.stride() == x.stride()
    del dx, want_dx
    row = dict(input=label, shape=list(x.shape), stride=list(x.stride()),
               dtype=str(x.dtype).split(".")[-1],
               equal=bool(torch.equal(s1, s2) and torch.equal(q1, q2) and moments_equal
                          and dx_equal and err <= bn_stats.SUM_RTOL),
               max_abs_err=err, moments_equal=moments_equal, dx_equal=dx_equal,
               plan=list(bn_stats._plan(*bn_stats._check_activation("k5_check", x))),
               device_us=device_us(lambda: bn_stats.bn_sums(x)),
               dx_device_us=device_us(lambda: bn_stats.bn_moments_dx(x, mean, dmean, dvar)))
    if baseline is not None:
        row["without_device_us"] = device_us(lambda: bn_stats.bn_sums(baseline))
        row["without_shape"] = list(baseline.shape)
    return row


def phase_k5_new_inputs(bn_stats):
    """K5 on what stem_s2d and bn_stats_subsample give it: the phase view of
    the stem's conv0 output (16, 128, 208, 208) in NCHW and channels-last
    memory, f32 and bf16 (beside K5 on the un-rewritten conv0 output, 16 × 32
    × 416²), and the stride-2 subsample copy of a 52² activation (beside K5
    on the whole activation, and the copy's own device µs)."""
    from yolov3_tpu_torch.models import layers
    from yolov3_tpu_torch.ops.cuda.kernel_times import device_us

    gen = torch.Generator(device="cuda").manual_seed(20)
    images = torch.rand((16, 3, 416, 416), generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    kernel = torch.randn((32, 3, 3, 3), generator=gen, device="cuda") * 0.3
    rows = []
    with torch.no_grad():
        plain0 = layers.conv2d(images, kernel, 1, 1)  # (16, 32, 416, 416)
        phase0 = layers.conv2d(images, layers.s2d_phase_kernel_conv0(kernel), 2, 1,
                               explicit_pad=((1, 2), (1, 2)))  # (16, 128, 208, 208)
    for dtype in (torch.float32, torch.bfloat16):
        for fmt, name in ((torch.contiguous_format, "nchw"), (torch.channels_last, "channels_last")):
            x = phase0.to(dtype).contiguous(memory_format=fmt)
            view = layers._phase_view(x, 4)
            if view.data_ptr() != x.data_ptr():
                raise AssertionError("K5: the phase view copied the activation")
            # the view holds the un-rewritten activation's values, per channel
            row = k5_check(bn_stats, view, f"phase view {name}",
                           baseline=plain0.to(dtype).contiguous(memory_format=fmt))
            log(f"K5 phase view {json.dumps(row)}")
            rows.append(row)
            del x, view
    del plain0, phase0
    act = torch.randn((16, 256, 52, 52), generator=gen, device="cuda") * 2.0 + 0.5
    for fmt, name in ((torch.contiguous_format, "nchw"), (torch.channels_last, "channels_last")):
        x = act.contiguous(memory_format=fmt)
        sub = layers._subsampled(x, 2)
        row = k5_check(bn_stats, sub, f"subsample copy {name}", baseline=x)
        row["copy_device_us"] = device_us(lambda: layers._subsampled(x, 2))
        log(f"K5 subsample {json.dumps(row)}")
        rows.append(row)
    bad = [r for r in rows if not r["equal"]]
    if bad:
        raise AssertionError(f"K5 disagrees with its plain version on its new inputs: {bad}")
    return rows


def extras_config(name, **keys):
    """The toy training config of phase 15 for one phase-20 run."""
    files = toy_training_files()
    ckpt = os.path.join(EXTRAS_DIR, name, "yolov3_toy.tf")
    for suffix in (".npz", ".train_state.npz", ".ema.npz"):
        if os.path.exists(ckpt + suffix):
            os.remove(ckpt + suffix)
    config = dict(
        model_config_file=files["model"], image_size=416, batch_size=16, max_bboxes=100,
        debug_mode=False, anchors_file=files["anchors"], learning_rate=0.001,
        early_stop_patience=13, epochs=2, training_mode="fit", render_dataset_example=False,
        max_dataset_examples=None, transfer_learning_config={"transfer_list": ["none"]},
        dataset_config={"input_data_source": "tfrecords",
                        "tfrecords": {"train": files["train"], "valid": files["valid"]}},
        classes_name_file=files["names"], output_checkpoints_path=ckpt, early_stopping=False,
        weights_save_peroid=100, resume=False, mixed_precision=False, seed=0)
    config.update(keys)
    return config


ALL_KEYS = dict(
    augmentation={"flip": True, "scale_jitter": 0.25, "brightness": 0.1, "contrast": 0.1,
                  "mosaic": 0.5, "hue": 0.1, "saturation": 1.5, "exposure": 1.5},
    qat="full", stem_s2d=True, multi_scale={"sizes": [320, 416], "interval": 1},
    device_dataset={"dtype": "uint8"}, bn_stats_subsample=2, remat="conv",
    mixed_precision=True)


def counted_train(bn_stats, handler, config):
    """One ``Train`` call with K5's counts and the peak memory set to 0 just
    before it; BatchNorm statistics taken through a phase view (a view of
    another tensor) are counted on the way, and the training BatchNorm tails
    by route (``bn_leaky.tails``) → (train state, row)."""
    import re

    from yolov3_tpu_torch.apps.train_app import Train
    from yolov3_tpu_torch.models import layers
    from yolov3_tpu_torch.ops.cuda import bn_leaky

    through_view = [0]
    moments = layers.bn_moments

    def counting(x):
        through_view[0] += x._base is not None
        return moments(x)

    handler.lines.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bn_stats.bn_sums.launches = bn_stats.bn_moments_dx.launches = 0
    tails = bn_leaky.bn_leaky.tails.copy()
    layers.bn_moments = counting
    t0 = time.monotonic()
    try:
        state = Train()(**config)
        torch.cuda.synchronize()
    finally:
        layers.bn_moments = moments
    text = "\n".join(handler.lines)
    steps = sum(int(v) for v in re.findall(r"epoch \d+: (\d+) steps in", text))
    epoch_s = [float(v) for v in re.findall(r"epoch \d+: \d+ steps in (\S+)s", text)]
    losses = [float(v) for v in re.findall(r"epoch \d+: train_loss (\S+)", text)]
    val = [float(v) for v in re.findall(r"epoch \d+: val_loss (\S+)", text)]
    row = dict(seconds=time.monotonic() - t0, steps=steps, train_losses=losses, val_losses=val,
               k5_launches=[bn_stats.bn_sums.launches, bn_stats.bn_moments_dx.launches],
               k5_launches_per_step=[bn_stats.bn_sums.launches / max(steps, 1),
                                     bn_stats.bn_moments_dx.launches / max(steps, 1)],
               k5_phase_view_calls=through_view[0],
               k7_tails=dict(bn_leaky.bn_leaky.tails - tails),
               last_epoch_ms_per_step=epoch_s[-1] * 1e3 / (steps // len(epoch_s))
               if epoch_s else None,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    return state, text, row


def step_profile(key, options, bodies, nc, files, batch=16):
    """The train step of one key alone on one resident batch of ``batch``
    images: ms a step (host clock around 5 steps ending in a synchronize,
    after two), device launches and busy ms of one step (profiler), peak
    memory of a step."""
    from yolov3_tpu_torch.config import get_anchors
    from yolov3_tpu_torch.models import init_model, parse_model_config
    from yolov3_tpu_torch.models.network import head_grid_sizes, to_device
    from yolov3_tpu_torch.ops.s2d import s2d_stem_train
    from yolov3_tpu_torch.parallel.train_step import init_train_state, make_adam, make_train_step

    spec = parse_model_config(files["model"], nc)
    params, st = init_model(spec, torch.Generator().manual_seed(0))
    optimizer = make_adam(0.001)
    opts = dict(options)
    step_spec = s2d_stem_train(spec, 416) if opts.pop("stem_s2d", False) else spec
    step = make_train_step(step_spec, get_anchors(files["anchors"]), head_grid_sizes(spec, 416),
                           batch, optimizer, **opts)
    state = [init_train_state(to_device(params, "cuda"), to_device(st, "cuda"), optimizer)]
    images = torch.from_numpy(smoke_images(bodies, batch)).cuda()
    labels = torch.from_numpy(seeded_labels(np.random.RandomState(1), batch, nc)).cuda()

    def one_step():
        state[0], _ = step(state[0], images, labels)

    one_step()
    one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        one_step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    peak = torch.cuda.max_memory_allocated() / 1e9
    profiled = device_time_by_kernel(one_step)
    row = dict(key=key, step_ms=ms, step_peak_memory_gb=peak)
    if profiled is None:
        row["profile"] = "not measured (the profiler showed no device time)"
    else:
        total, by_name, count, host_ms, _, in_order = profiled
        row.update(device_busy_ms=total, device_launches=count, host_enqueue_ms=host_ms,
                   k5_device_launches=sum("bn_moments_" in n or "bn_dx_kernel" in n
                                          for n, _ in in_order),
                   k5_device_ms=sum(ms_ for n, ms_ in by_name.items()
                                    if "bn_moments_" in n or "bn_dx_kernel" in n))
    del state
    return row


PER_KEY = {
    "plain": {}, "qat": {"qat": "full"},
    "augmentation": {"augmentation": ALL_KEYS["augmentation"]},
    "stem_s2d": {"stem_s2d": True}, "bn_stats_subsample": {"bn_stats_subsample": 2},
    "remat_true": {"remat": True}, "remat_conv": {"remat": "conv"},
    "multi_scale": {"multi_scale": [320, 416]},
    "device_dataset": {"device_dataset": {"dtype": "uint8"}},
}
STEP_OPTIONS = {"augmentation": "augment", "bn_stats_subsample": "bn_stats_subsample",
                "remat": "remat", "qat": "qat", "stem_s2d": "stem_s2d"}


def card_vs_cpu(bodies, files, nc):
    """The port against itself: augmentation's apply and QAT's integers card
    against CPU, and one stem_s2d step on the card against the un-rewritten
    one (loss 1e-4 relative, gradient leaves 2e-4 of the leaf max)."""
    from yolov3_tpu_torch.config import get_anchors
    from yolov3_tpu_torch.models import init_model, parse_model_config
    from yolov3_tpu_torch.models.network import head_grid_sizes, to_device
    from yolov3_tpu_torch.ops import augment, quantize
    from yolov3_tpu_torch.ops.s2d import s2d_stem_train
    from yolov3_tpu_torch.parallel.train_step import loss_and_grads

    row = {}
    images = torch.from_numpy(smoke_images(bodies, 16))
    labels = torch.from_numpy(seeded_labels(np.random.RandomState(2), 16, nc))
    draws = augment.draw_augment(16, augment.step_generator(0, 5), **ALL_KEYS["augmentation"])
    card = augment.apply_augment(images.cuda(), labels.cuda(), draws)
    cpu = augment.apply_augment(images, labels, draws)
    cpu_idx = [augment.source_indices(416, draws["offset"][:, k], draws["scale"])[0]
               for k in (1, 0)]
    card_idx = [augment.source_indices(416, draws["offset"][:, k].cuda(),
                                       draws["scale"].cuda())[0] for k in (1, 0)]
    row["augment"] = dict(
        image_max_abs_err=max_abs(card[0].cpu(), cpu[0]),
        label_max_abs_err=max_abs(card[1].cpu(), cpu[1]),
        indices_equal=all(torch.equal(a.cpu(), b) for a, b in zip(card_idx, cpu_idx)))

    spec = parse_model_config(files["model"], nc)
    params, st = init_model(spec, torch.Generator().manual_seed(0))
    kernels = [e["kernel"] for sm in params.values() for e in sm.values()]

    def integers(k):
        k32 = k.float()
        scale = torch.clamp(k32.abs().amax(dim=(1, 2, 3), keepdim=True),
                            min=1e-12) * quantize._INV_127
        return torch.round(k32 / scale)

    act = images.permute(0, 3, 1, 2) * 3.0 - 1.0
    row["qat"] = dict(
        kernels=len(kernels),
        integers_equal=all(torch.equal(integers(k.cuda()).cpu(), integers(k)) for k in kernels),
        fake_quant_equal=all(torch.equal(quantize.fake_quant_kernel(k.cuda()).cpu(),
                                         quantize.fake_quant_kernel(k)) for k in kernels),
        activation_equal=torch.equal(quantize.fake_quant_activation(act.cuda()).cpu(),
                                     quantize.fake_quant_activation(act)))

    # the stem rewrite on the card: the same loss as the plain stem, and
    # gradients as close to float64 as the plain stem's (phase 14: at this
    # seeded init two f32 gradients differ by percents of a leaf's largest
    # entry whoever computes them, so each is held against float64)
    from yolov3_tpu_torch.models import layers

    anchors = get_anchors(files["anchors"])
    grids = head_grid_sizes(spec, 416)
    b = 4
    runs = {}
    for name, step_spec, dtype in (("plain", spec, torch.float32),
                                   ("stem_s2d", s2d_stem_train(spec, 416), torch.float32),
                                   ("float64", spec, torch.float64)):
        moments = layers.bn_moments
        if dtype == torch.float64:  # plain autograd statistics: no kernel, no f32 sums
            layers.bn_moments = lambda x: (x.mean(dim=(0, 2, 3)), torch.clamp(
                (x * x).mean(dim=(0, 2, 3)) - x.mean(dim=(0, 2, 3)) ** 2, min=0.0))
        try:
            grads, _, metrics = loss_and_grads(
                step_spec, to_device(params, "cuda", dtype), to_device(st, "cuda", dtype),
                images[:b].cuda().to(dtype), labels[:b].cuda(), anchors, grids, b)
        finally:
            layers.bn_moments = moments
        runs[name] = (dict(tree_paths(to_device(grads, "cpu", torch.float64))),
                      float(metrics["total_loss"]))
    ref = runs["float64"][0]

    def leaf_errors(got):
        return sorted(float((got[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()),
                                                                 1e-12) for k in ref)

    plain, s2d = leaf_errors(runs["plain"][0]), leaf_errors(runs["stem_s2d"][0])
    direct = max(float((runs["stem_s2d"][0][k] - runs["plain"][0][k]).abs().max())
                 / max(float(runs["plain"][0][k].abs().max()), 1e-12) for k in ref)
    l0, l1 = runs["plain"][1], runs["stem_s2d"][1]
    row["stem_s2d_step"] = dict(
        batch=b, loss_plain=l0, loss_s2d=l1, loss_float64=runs["float64"][1],
        loss_rel_err=abs(l1 - l0) / abs(l0), grad_leaf_max_err_s2d_vs_plain=direct,
        vs_float64=dict(plain_worst=plain[-1], s2d_worst=s2d[-1],
                        plain_median=plain[len(plain) // 2], s2d_median=s2d[len(s2d) // 2]))
    grads_ok = (s2d[-1] <= max(2 * plain[-1], 2e-4)
                and s2d[len(s2d) // 2] <= max(2 * plain[len(plain) // 2], 2e-4))
    ok = (row["augment"]["image_max_abs_err"] <= 1e-6 and row["augment"]["indices_equal"]
          and row["augment"]["label_max_abs_err"] <= 1e-6
          and row["qat"]["integers_equal"] and row["qat"]["fake_quant_equal"]
          and row["qat"]["activation_equal"]
          and row["stem_s2d_step"]["loss_rel_err"] <= 1e-4 and grads_ok)
    log(f"trainer extras card vs CPU {json.dumps(row)}")
    if not ok:
        raise AssertionError(f"card against CPU / the rewrite against the plain step: {row}")
    return row


def phase_train_extras(inference_app, bn_stats, bodies, smi):
    """Phase 20: K5 on its new inputs, one ``Train`` run of YOLOv3-416 with
    every key of the slice on together, each key alone against the plain
    trainer, and the port on the card against itself on the CPU."""
    import ast
    import re

    from yolov3_tpu_torch.config import read_class_names

    files = toy_training_files()
    nc = len(read_class_names(files["names"]))
    result = {"card": smi, "k5_new_inputs": phase_k5_new_inputs(bn_stats)}
    torch.cuda.empty_cache()
    handler = _LogLines()
    logging.getLogger().addHandler(handler)
    try:
        # every key at once, 3 epochs (the main path of this slice)
        tb_dir, trace_dir = os.path.join(EXTRAS_DIR, "tb"), os.path.join(EXTRAS_DIR, "trace")
        for d in (tb_dir, trace_dir):
            for f in glob.glob(os.path.join(d, "*")):
                os.remove(f)
        config = extras_config("all_keys", epochs=3, tensorboard=tb_dir,
                               profile_trace_dir=trace_dir, **ALL_KEYS)
        state, text, row = counted_train(bn_stats, handler, config)
        scales = [ast.literal_eval(m)
                  for m in re.findall(r"multi_scale batches per size (\{[^}]*\})", text)]
        sizes_seen = sorted({int(k) for d in scales for k in d})
        predictor, _, _ = inference_app.build_serving_predictor(
            files["model"], files["names"], files["anchors"], config["output_checkpoints_path"],
            416, nms_score_threshold=0.1)
        _, _, scores, selected, num_valid = predictor(smoke_images(bodies, 4))
        torch.cuda.synchronize()
        row.update(keys=sorted(ALL_KEYS) + ["profile_trace_dir", "tensorboard"],
                   event_files=len(glob.glob(os.path.join(tb_dir, "events.out.tfevents.*"))),
                   trace_files=[os.path.getsize(f) for f in
                                glob.glob(os.path.join(trace_dir, "trace.*.json"))],
                   sizes_per_epoch=scales, served=dict(
                       shape=list(selected.shape), detections=int(num_valid.sum()),
                       scores_finite=bool(torch.isfinite(scores).all())))
        log(f"trainer extras all keys {json.dumps(row)}")
        finite = all(np.isfinite(row["train_losses"] + row["val_losses"]))
        if not (finite and len(row["train_losses"]) == 3 and row["steps"] == 6
                and min(row["k5_launches"]) > 0 and row["k5_phase_view_calls"] > 0
                and set(row["k7_tails"]) == {"fused"} and row["event_files"] == 1 and len(row["trace_files"]) == 1
                and min(row["trace_files"]) > 0 and sizes_seen == [320, 416]
                and row["served"]["shape"] == [4, 100] and row["served"]["scores_finite"]):
            raise AssertionError(f"the all-keys run failed its checks: {row}")
        result["all_keys"] = row
        all_keys_launches = row["k5_launches"]
        del state, predictor

        # each key alone, 1 epoch, fp32: the trainer's run, then its step
        per_key = []
        for key, keys in PER_KEY.items():
            _, _, row = counted_train(bn_stats, handler, extras_config(key, epochs=1, **keys))
            options = {STEP_OPTIONS[k]: v for k, v in keys.items() if k in STEP_OPTIONS}
            if key == "plain" or options:
                row.update(step_profile(key, options, bodies, nc, files))
            row["key"] = key
            log(f"trainer extras per key {json.dumps(row)}")
            if not (row["steps"] == 2 and all(np.isfinite(row["train_losses"]))
                    and min(row["k5_launches"]) > 0 and set(row["k7_tails"]) == {"fused"}):
                raise AssertionError(f"the {key} run failed its checks: {row}")
            per_key.append(row)
            torch.cuda.empty_cache()
        result["per_key"] = per_key
    finally:
        logging.getLogger().removeHandler(handler)
    result["card_vs_cpu"] = card_vs_cpu(bodies, files, nc)
    return result, all_keys_launches


def served_head_overflow(files, ckpt, images, compute_dtype):
    """Which head, anchor and term of a checkpoint's served heads overflow
    ``exp`` in f32 (the decode's w/h): per head and anchor, the largest w and
    h logits and how many exceed log(FLT_MAX); beside them the largest w/h
    logit of the same weights with BatchNorm on the batch's statistics
    (training mode) instead of the running ones."""
    from yolov3_tpu_torch.config import read_class_names
    from yolov3_tpu_torch.io.resolve import load_weights
    from yolov3_tpu_torch.models import init_model, parse_model_config
    from yolov3_tpu_torch.models.network import apply_model, fold_batch_norm, to_device

    spec = parse_model_config(files["model"], len(read_class_names(files["names"])))
    params, st = load_weights(spec, *init_model(spec, torch.Generator().manual_seed(0)), ckpt)
    folded = to_device(fold_batch_norm(params, st), "cuda", compute_dtype)
    x = images.cuda().to(compute_dtype or torch.float32)
    with torch.inference_mode():
        heads = apply_model(spec, folded, {}, x)
        batch_heads, _ = apply_model(spec, to_device(params, "cuda", compute_dtype),
                                     to_device(st, "cuda"), x, train=True)
    rows = []
    for i, head in enumerate(heads):
        h = head.float()
        for a in range(h.shape[3]):
            for term, j in (("w", 2), ("h", 3)):
                v = h[..., a, j]
                rows.append(dict(head=i, grid=h.shape[1], anchor=a, term=term,
                                 max_logit=float(v.max()), overflow=int((v > EXP_F32_LIMIT).sum()),
                                 nan=int(torch.isnan(v).sum())))
    return dict(exp_f32_limit=EXP_F32_LIMIT, heads=[
        r for r in rows if r["overflow"] or r["nan"]] or "none overflow",
        largest_wh_logit=max(r["max_logit"] for r in rows),
        largest_wh_logit_batch_statistics=max(float(h[..., 2:4].float().max())
                                              for h in batch_heads))


# --- the model-file entry points: Darknet convert, then BN recalibration ---

CONVERT_DIR = os.path.join(ROOT, "build", "smoke_convert")
YOLOV3_WEIGHTS_BYTES = 248_007_048  # the published yolov3.weights (80 classes)


def wh_logits(spec, params, state, images):
    """Per head, the largest |w/h logit| of the folded forward on the card,
    and whether every one is below exp's f32 limit."""
    from yolov3_tpu_torch.models.network import apply_model, fold_batch_norm, to_device

    with torch.inference_mode():
        heads = apply_model(spec, to_device(fold_batch_norm(params, state), "cuda"), {},
                            images.cuda())
    return [dict(grid=h.shape[1], largest_abs_wh_logit=float(h[..., 2:4].abs().max()),
                 below_exp_limit=bool((h[..., 2:4] <= EXP_F32_LIMIT).all())) for h in heads]


def phase_convert(inference_app, bodies, nms_kernel, conv1x1, conv_int8, resblock, smi):
    """Phase 21: a synthetic Darknet ``yolov3.weights`` (YOLOv3-416, 80
    classes, seeded init with the BN running state moved off its init: the
    published file's layout and size), converted on the card by ``cli
    convert``, written back byte-identical, then served from the converted
    checkpoint in fp32 (heads card vs CPU within 1e-3) and in ``int8_chain``
    (K1, K3, K4, K6 and K8 counted over each tier's serving call)."""
    import contextlib
    import io

    import yaml

    from yolov3_tpu_torch.apps import cli
    from yolov3_tpu_torch.config import read_class_names
    from yolov3_tpu_torch.io.darknet import save_darknet_weights
    from yolov3_tpu_torch.io.resolve import load_weights
    from yolov3_tpu_torch.models import fold_batch_norm, init_model, parse_model_config
    from yolov3_tpu_torch.models.network import apply_model, to_device
    from yolov3_tpu_torch.ops.cuda import bias_act
    from yolov3_tpu_torch.tree import tree_map

    os.makedirs(CONVERT_DIR, exist_ok=True)
    model = os.path.join(ROOT, "config/models/yolov3/model.yaml")
    names = os.path.join(ROOT, "datasets/coco2012/coco.names")
    anchors = os.path.join(ROOT, "datasets/coco2012/anchors.txt")
    spec = parse_model_config(model, len(read_class_names(names)))
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    state = tree_map(lambda v: v + 0.25, state)
    weights = os.path.join(CONVERT_DIR, "yolov3.weights")
    save_darknet_weights(spec, params, state, weights)
    size = os.path.getsize(weights)
    if size != YOLOV3_WEIGHTS_BYTES:
        raise AssertionError(f"the synthetic yolov3.weights has {size} bytes, "
                             f"expected {YOLOV3_WEIGHTS_BYTES}")
    del params, state

    ckpt = os.path.join(CONVERT_DIR, "yolov3_converted.tf")
    config = os.path.join(CONVERT_DIR, "convert_config.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(dict(num_classes=80, weights_file=weights, output_weights_file=ckpt,
                            model_config_file=model), f)
    handler = _LogLines()
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    out = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(["convert", "--config", config])
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    convert_s = time.monotonic() - t0
    parts = [ln for ln in handler.lines if ln.startswith("convert seconds:")]
    if "sanity check passed" not in out.getvalue():
        raise AssertionError(f"convert: no sanity check passed in {out.getvalue()!r}")

    params, state = load_weights(spec, *init_model(spec, torch.Generator().manual_seed(1)), ckpt)
    again = os.path.join(CONVERT_DIR, "yolov3_again.weights")
    save_darknet_weights(spec, params, state, again)
    with open(weights, "rb") as a, open(again, "rb") as b:
        round_trip = a.read() == b.read()

    # fp32 heads, card against CPU, on the same B=4 batch
    folded = fold_batch_norm(params, state)
    four = torch.from_numpy(smoke_images(bodies, 4))
    with torch.inference_mode():
        on_cpu = apply_model(spec, folded, {}, four)
        on_card = apply_model(spec, to_device(folded, "cuda"), {}, four.cuda())
    head_err = max(max_abs(g.cpu(), c) for g, c in zip(on_card, on_cpu))
    head_scale = max(float(c.abs().max()) for c in on_cpu)
    finite = all(bool(torch.isfinite(h).all()) for h in on_card)
    del folded, on_cpu, on_card, params, state

    batch = smoke_images(bodies, 16)
    wrappers = dict(nms_sweep=nms_kernel.suppression_sweep,
                    conv1x1_int8=conv1x1.conv1x1_int8_requant,
                    resblock_int8=resblock.fused_resblock, conv_int8=conv_int8.conv_int8,
                    bias_act=bias_act.bias_act)
    served, counts = {}, {}
    for tier, quantize in (("fp32", None), ("int8_chain", "int8_chain")):
        predictor, _, _ = inference_app.build_serving_predictor(
            model, names, anchors, ckpt, 416, nms_score_threshold=0.1, quantize=quantize,
            calibration_images_dir=CALIBRATION_DIR if quantize else None)
        predictor(batch)  # warm-up
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t1 = time.monotonic()
        boxes, _, scores, selected, num_valid = predictor(batch)
        torch.cuda.synchronize()
        served[tier] = dict(seconds=time.monotonic() - t1, detections=int(num_valid.sum()),
                            shape=list(selected.shape),
                            boxes_finite=bool(torch.isfinite(boxes).all()),
                            scores_finite=bool(torch.isfinite(scores).all()))
        counts[tier] = {k: w.launches for k, w in wrappers.items()}
        del predictor
    torch.cuda.empty_cache()

    row = dict(card=smi, weights_bytes=size, convert_call_seconds=convert_s,
               convert_parts=parts, byte_identical_round_trip=round_trip,
               fp32_heads_card_vs_cpu_max_abs_err=head_err, fp32_heads_max_abs=head_scale,
               fp32_heads_finite=finite, served=served, launches=counts)
    log(f"convert YOLOv3-416 {json.dumps(row)}")
    chain = counts["int8_chain"]
    if not (round_trip and finite and head_err <= 1e-3 and len(parts) == 1
            and min(chain.values()) > 0
            and (counts["fp32"]["bias_act"], chain["bias_act"]) == K8_A_FORWARD
            and all(s["shape"] == [16, 100] and s["scores_finite"] for s in served.values())):
        raise AssertionError(f"convert and serve failed its checks: {row}")
    return row, chain


def recalibrated_state_64(spec, params, state, batches, momentum):
    """The recalibration in float64 on the CPU, BatchNorm moments by plain
    float64 ops (no kernel, no f32 sums): the referee of phase 22."""
    from yolov3_tpu_torch.models import layers
    from yolov3_tpu_torch.models.network import apply_model, to_device
    from yolov3_tpu_torch.tree import tree_map

    def moments64(x):
        mean = x.mean(dim=(0, 2, 3))
        return mean, torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)

    p, s = to_device(params, "cpu", torch.float64), to_device(state, "cpu", torch.float64)
    kernel_moments, layers.bn_moments = layers.bn_moments, moments64
    try:
        acc = None
        with torch.no_grad():
            for images in batches:
                _, new = apply_model(spec, p, s, torch.from_numpy(images).double(), train=True)
                stat = tree_map(lambda n, o: (n - momentum * o) / (1.0 - momentum), new, s)
                acc = stat if acc is None else tree_map(torch.add, acc, stat)
    finally:
        layers.bn_moments = kernel_moments
    return tree_map(lambda a: a / len(batches), acc)


def phase_recalibrate(inference_app, bn_stats, bodies, smi):
    """Phase 22: phase 15's fp32 checkpoint recalibrated through
    ``python -m yolov3_tpu_torch.tools.bn_recalibrate`` at 416 over the
    shapes_toy train split (2 batches of 16) on the card, K5 counted (72
    forward launches a batch, none backward), then on the CPU: the state card
    against CPU within 1e-3 of each leaf's largest |value| (else each held
    against a float64 referee, all three printed), the params byte-identical
    to the input's; then, as findings, the w/h logits and served boxes before
    and after."""
    from yolov3_tpu_torch.config import read_class_names
    from yolov3_tpu_torch.io.checkpoint import _flatten, load_checkpoint
    from yolov3_tpu_torch.io.resolve import load_weights
    from yolov3_tpu_torch.models import init_model, parse_model_config
    from yolov3_tpu_torch.models.layers import BN_MOMENTUM
    from yolov3_tpu_torch.tools import bn_recalibrate

    files = toy_training_files()
    ckpt = os.path.join(ROOT, "build", "smoke_train", "fp32", "yolov3_toy.tf")
    data_root = os.path.join(ROOT, "datasets", "shapes_toy")
    outs, seconds = {}, {}
    cwd = os.getcwd()
    try:
        for dev in ("cuda", "cpu"):
            outs[dev] = os.path.join(CONVERT_DIR, f"yolov3_toy_recal_{dev}.tf")
            bn_stats.bn_sums.launches = bn_stats.bn_moments_dx.launches = 0
            t0 = time.monotonic()
            bn_recalibrate.main(["--ckpt", ckpt, "--model_config", files["model"],
                                 "--data_root", data_root, "--split", "train",
                                 "--image_size", "416", "--batches", "2", "--batch_size", "16",
                                 "--out", outs[dev], "--device", dev])
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = [bn_stats.bn_sums.launches, bn_stats.bn_moments_dx.launches]
            seconds[dev] = time.monotonic() - t0
    finally:
        os.chdir(cwd)

    flat = {k: _flatten(load_checkpoint(p + ".npz")[0]) for k, p in
            (("input", ckpt), ("cuda", outs["cuda"]), ("cpu", outs["cpu"]))}
    params_identical = all(flat[d][k].tobytes() == v.tobytes()
                           for d in ("cuda", "cpu") for k, v in flat["input"].items()
                           if k.startswith("params/"))
    state_keys = sorted(k for k in flat["input"] if k.startswith("bn_state/"))

    def rel_errs(a, b):  # per leaf: max |a − b| over the leaf's largest |b|
        return sorted(((float(np.abs(a[k].astype(np.float64) - b[k]).max())
                        / max(float(np.abs(b[k]).max()), 1e-30), k) for k in state_keys),
                      reverse=True)

    card_cpu = rel_errs(flat["cuda"], flat["cpu"])
    moved = max(float(np.abs(flat["cuda"][k] - flat["input"][k]).max()) for k in state_keys)
    row = dict(card=smi, seconds=seconds, k5_launches_forward_backward=launches,
               params_byte_identical=params_identical, state_leaves=len(state_keys),
               state_largest_move=moved,
               state_card_vs_cpu=dict(worst=card_cpu[0][0], worst_leaf=card_cpu[0][1],
                                      median=card_cpu[len(card_cpu) // 2][0]))
    agree = card_cpu[0][0] <= 1e-3
    spec = parse_model_config(files["model"], len(read_class_names(files["names"])))
    if not agree:
        params, state = load_weights(spec, *init_model(spec, torch.Generator().manual_seed(0)),
                                     ckpt)
        batches = list(bn_recalibrate.tfrecord_batches(data_root, "train", 416, 16, 2))
        ref = _flatten({"bn_state": recalibrated_state_64(spec, params, state, batches,
                                                          BN_MOMENTUM)})
        card64, cpu64 = rel_errs(flat["cuda"], ref), rel_errs(flat["cpu"], ref)
        row["state_vs_float64"] = dict(card_worst=card64[0][0], cpu_worst=cpu64[0][0],
                                       card_median=card64[len(card64) // 2][0],
                                       cpu_median=cpu64[len(cpu64) // 2][0],
                                       card_worst_leaf=card64[0][1], cpu_worst_leaf=cpu64[0][1])
        agree = card64[0][0] <= max(2 * cpu64[0][0], 1e-3)

    # the finding: w/h logits and served boxes before and after, on phase
    # 15's served images and on the first batch the statistics came from
    images = torch.from_numpy(smoke_images(bodies, 16))
    train_batch = torch.from_numpy(next(bn_recalibrate.tfrecord_batches(data_root, "train",
                                                                         416, 16, 1)))
    for tag, path in (("before", ckpt), ("after", outs["cuda"])):
        params, state = load_weights(spec, *init_model(spec, torch.Generator().manual_seed(0)),
                                     path)
        predictor, _, _ = inference_app.build_serving_predictor(
            files["model"], files["names"], files["anchors"], path, 416,
            nms_score_threshold=0.1)
        boxes, _, scores, _, num_valid = predictor(images.numpy())
        torch.cuda.synchronize()
        row[tag] = dict(heads=wh_logits(spec, params, state, images),
                        heads_on_train_batch=wh_logits(spec, params, state, train_batch),
                        served_boxes_finite=bool(torch.isfinite(boxes).all()),
                        served_scores_finite=bool(torch.isfinite(scores).all()),
                        served_detections=int(num_valid.sum()))
        del predictor
    log(f"recalibrate phase 15 YOLOv3-416 {json.dumps(row)}")
    if not (agree and params_identical and launches == [144, 0] and moved > 0):
        raise AssertionError(f"recalibration failed its checks: {row}")
    return row, launches


ARTIFACT_DIR = os.path.join(ROOT, "build", "smoke_artifact")
ARTIFACT_BATCHES = (1, 4, 16)
# phase 23's seeded YOLOv3-416, 80 COCO classes: model, class names, anchors
ARTIFACT_MODEL = tuple(os.path.join(ROOT, f) for f in (
    "config/models/yolov3/model.yaml", "datasets/coco2012/coco.names",
    "datasets/coco2012/anchors.txt"))
NMS_OUTPUTS = ("bboxes", "class_idx", "scores", "selected", "num_valid")


def artifact_child(inputs, *paths):
    """``python3 chip_smoke.py --load-artifact [--deterministic] <inputs.npz>
    <artifact.zip> …``, which phase 23 starts: in a process of its own, load
    each artifact on the card and answer the images of ``inputs`` at B = 1, 4
    and 16; write every output to ``<artifact>.out.npz`` and print one JSON
    line (seconds to load, to answer the first call, the kernels' launches of
    one B=16 call). ``--deterministic`` pins cuDNN to deterministic
    algorithms without benchmarking (``cudnn_pinned``) before anything runs,
    and then this process also builds phase 23's seeded fp32 predictor
    eagerly and writes its answers to ``<artifact>.eager.npz`` (the eager
    program in a process of its own, beside the loaded one). The fp32
    precision is the artifact's own (its manifest, applied by the loader):
    this process sets none."""
    from yolov3_tpu_torch.export.aot import load_detector_artifact
    from yolov3_tpu_torch.ops.cuda import bias_act, conv1x1, conv_int8, nms_kernel, resblock

    eager = inputs == "--deterministic"
    if eager:
        cudnn_pinned(True)
        inputs = paths[0]
        paths = paths[1:]
    wrappers = dict(nms_sweep=nms_kernel.suppression_sweep,
                    conv1x1_int8=conv1x1.conv1x1_int8_requant,
                    resblock_int8=resblock.fused_resblock, conv_int8=conv_int8.conv_int8,
                    bias_act=bias_act.bias_act)
    images = np.load(inputs)["images"]
    rows = {}
    for path in paths:
        t0 = time.monotonic()
        predict, manifest = load_detector_artifact(path)
        load_s = time.monotonic() - t0
        outs, seconds = {}, {}
        for b in ARTIFACT_BATCHES:
            t1 = time.monotonic()
            res = predict(images[:b])
            torch.cuda.synchronize()
            seconds[b] = time.monotonic() - t1
            outs.update({f"{name}_{b}": t.cpu().numpy() for name, t in zip(NMS_OUTPUTS, res)})
        for w in wrappers.values():
            w.launches = 0
        predict(images[:16])
        torch.cuda.synchronize()
        np.savez(f"{path}.out.npz", **outs)
        rows[os.path.basename(path)] = dict(
            quantize=manifest["quantize"], load_s=load_s, first_call_s=seconds[1],
            call_s={str(b): v for b, v in seconds.items()},
            launches_b16={k: w.launches for k, w in wrappers.items()})
        if eager:
            from yolov3_tpu_torch.apps.inference_app import build_serving_predictor

            del predict
            here = build_serving_predictor(*ARTIFACT_MODEL, None, 416, nms_score_threshold=0.1,
                                           seed=0)[0]
            eager_outs = {}
            with torch.inference_mode():
                for b in ARTIFACT_BATCHES:
                    res = here(images[:b])
                    eager_outs.update({f"{name}_{b}": t.cpu().numpy()
                                       for name, t in zip(NMS_OUTPUTS, res)})
            np.savez(f"{path}.eager.npz", **eager_outs)
            rows[os.path.basename(path)]["eager_equals_loaded_here"] = all(
                np.array_equal(eager_outs[k], outs[k]) for k in outs)
    print(json.dumps(rows), flush=True)
    return 0


def cudnn_pinned(on: bool):
    """cuDNN's algorithm choice pinned (deterministic algorithms, no
    benchmarking) or back to PyTorch's defaults (heuristics, no
    benchmarking)."""
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def op_host_cost(nms_kernel, conv1x1):
    """The host's µs a call of K1 and of K3 at serving shapes (K1: B=16,
    K=512; K3: the 13² 1×1 conv at B=16, 1024→512), through the
    ``yolov3_torch`` op, through its wrapper, and calling the op's CUDA
    kernel (the ctypes launch) directly, in turns (direct, op, wrapper,
    wrapper, op, direct): ``host_us``, the device never waited for. Under
    ``inference_mode``, as the predictors call them, and with autograd on
    (a ``custom_op`` then also passes its autograd kernel)."""
    from yolov3_tpu_torch.ops.cuda.kernel_times import sweep_case

    rng = np.random.RandomState(23)
    mat, valid = sweep_case(16, 512)
    xq = torch.from_numpy(rng.randint(-127, 128, (16 * 169, 1024)).astype(np.int8)).cuda()
    wq = torch.from_numpy(rng.randint(-127, 128, (512, 1024)).astype(np.int8)).cuda()
    scale = torch.from_numpy((rng.rand(512) * 1e-4).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.randn(512).astype(np.float32)).cuda()
    inv = torch.tensor([17.3], dtype=torch.float32, device="cuda")
    calls = {
        "K1 nms_sweep B=16 K=512": dict(
            direct=lambda: nms_kernel._sweep_cuda(mat, valid),
            op=lambda: torch.ops.yolov3_torch.suppression_sweep.default(mat, valid),
            wrapper=lambda: nms_kernel.suppression_sweep(mat, valid)),
        "K3 conv1x1_int8 M=2704 1024->512": dict(
            direct=lambda: conv1x1._conv1x1_cuda(xq, wq, scale, bias, inv, True, torch.int8),
            op=lambda: torch.ops.yolov3_torch.conv1x1_int8_requant.default(
                xq, wq, scale, bias, inv, True, torch.int8),
            wrapper=lambda: conv1x1.conv1x1_int8_requant(xq, wq, scale, bias, inv, leaky=True)),
    }
    rows = {}
    for mode, context in (("inference_mode", torch.inference_mode),
                          ("autograd", torch.enable_grad)):
        for name, fns in calls.items():
            us = {k: [] for k in fns}
            with context():
                for k in ("direct", "op", "wrapper", "wrapper", "op", "direct"):
                    us[k].append(host_us(fns[k], 200))
            rows[f"{name}, {mode}"] = dict(
                us, op_minus_direct_us=float(np.mean(us["op"]) - np.mean(us["direct"])))
    return rows


def phase_artifact(inference_app, serve_app, nms_mod, bodies, nms_kernel, conv1x1, conv_int8,
                   resblock, smi):
    """Phase 23: the serving artifact on the card. The seeded YOLOv3-416 (80
    COCO classes) in ``fp32`` and ``int8_chain`` (calibrated on the smoke
    images), each exported for ``cuda`` (``export/aot.py``) before it has
    answered anything; a process of its own loads both artifacts and answers
    B = 1, 4 and 16 (``artifact_child``), held against the eager predictor on
    the same images: ``int8_chain`` bit-equal, fp32 NMS index-exact with
    boxes within 1e-5 or phase 6's near-tie witness; the exported predictor
    after the export bit-equal to a copy taken before it. One loaded B=16
    call launches K1 1, K3 11, K4 23 and K6 15 times (``int8_chain``; fp32:
    K1 once), counted here in this process. Eager against loaded at B=16, in
    turns: event-loop ms (CUDA events) and device-busy ms (profiler). The
    host's µs a call of an op against its direct ctypes launch
    (``op_host_cost``). Then the ``int8_chain`` tier served from its model
    keys and from its artifact through ``Serve``'s ``artifact:`` key, with
    phase 5's closed-loop clients, two short windows each in turns."""
    import copy

    from yolov3_tpu_torch.export import aot
    from yolov3_tpu_torch.ops.cuda import bias_act

    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    model, names, anchors = ARTIFACT_MODEL
    images = smoke_images(bodies, 16)
    inputs = os.path.join(ARTIFACT_DIR, "inputs.npz")
    np.savez(inputs, images=images)
    batch16 = torch.from_numpy(images).cuda()
    wrappers = dict(nms_sweep=nms_kernel.suppression_sweep,
                    conv1x1_int8=conv1x1.conv1x1_int8_requant,
                    resblock_int8=resblock.fused_resblock, conv_int8=conv_int8.conv_int8,
                    bias_act=bias_act.bias_act)
    want_launches = {"fp32": dict(nms_sweep=1, conv1x1_int8=0, resblock_int8=0, conv_int8=0,
                                  bias_act=K8_A_FORWARD[0]),
                     "int8_chain": dict(nms_sweep=1, conv1x1_int8=11, resblock_int8=23,
                                        conv_int8=15, bias_act=K8_A_FORWARD[1])}
    tiers, predictors, paths = {}, {}, {}
    for tier, quantize in (("fp32", None), ("int8_chain", "int8_chain")):
        t0 = time.monotonic()
        predictor, class_names, model_name = inference_app.build_serving_predictor(
            model, names, anchors, None, 416, nms_score_threshold=0.1, quantize=quantize,
            calibration_images_dir=CALIBRATION_DIR if quantize else None, seed=0)
        build_s = time.monotonic() - t0
        before = aot.as_predict(copy.deepcopy(predictor.module), predictor.device)
        t1 = time.monotonic()
        programs = aot.export_detector(predictor.module, 416, ("cuda",))
        export_s = time.monotonic() - t1
        ops = sorted({str(n.target) for n in programs["cuda"].graph_module.graph.nodes
                      if str(n.target).startswith("yolov3_torch.")})
        paths[tier] = os.path.join(ARTIFACT_DIR, f"yolov3_416_{tier}.zip")
        t2 = time.monotonic()
        aot.save_detector_artifact(paths[tier], programs, dict(
            model_name=model_name, image_size=416, class_names=list(class_names),
            yolo_max_boxes=100, nms_iou_threshold=0.5, nms_score_threshold=0.1,
            quantize=quantize, compute_precision=None, nms_per_class=False, letterbox=False,
            source_config=None))
        save_s = time.monotonic() - t2
        del programs
        # the exported predictor answers as its copy from before the export
        with torch.inference_mode():
            unchanged = all(torch.equal(x, y) for b in (1, 16)
                            for x, y in zip(predictor(batch16[:b]), before(batch16[:b])))
        del before
        predictors[tier] = predictor
        tiers[tier] = dict(build_s=build_s, export_s=export_s, save_s=save_s,
                           artifact_mb=os.path.getsize(paths[tier]) / 1e6, program_ops=ops,
                           eager_unchanged_by_export=unchanged)
        log(f"artifact {tier} {json.dumps(tiers[tier])}")
        if not unchanged:
            raise AssertionError(f"{tier}: exporting changed the eager predictor's answers")
        torch.cuda.empty_cache()

    # a fresh process loads both artifacts and answers B = 1, 4, 16
    t0 = time.monotonic()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--load-artifact", inputs,
                            paths["fp32"], paths["int8_chain"]],
                           capture_output=True, text=True, timeout=600)
    child_s = time.monotonic() - t0
    if child.returncode != 0:
        raise AssertionError(f"the artifact process failed (rc {child.returncode}): "
                             f"{child.stderr[-3000:]}")
    child_rows = json.loads(child.stdout.strip().splitlines()[-1])
    nms_kw = dict(max_boxes=100, iou_threshold=0.5, score_threshold=0.1)
    for tier, path in paths.items():
        got = np.load(f"{path}.out.npz")
        compared = {}
        for b in ARTIFACT_BATCHES:
            with torch.inference_mode():
                eager = [t.cpu() for t in predictors[tier](batch16[:b])]
            loaded = [torch.from_numpy(got[f"{name}_{b}"]) for name in NMS_OUTPUTS]
            equal = all(torch.equal(a, e) for a, e in zip(loaded, eager))
            nms_exact = torch.equal(loaded[3], eager[3]) and torch.equal(loaded[4], eager[4])
            witnesses, box_err, score_err = compare_detections(nms_mod, loaded, eager, nms_kw)
            compared[b] = dict(bit_equal=equal, nms_index_exact=nms_exact,
                               boxes_max_abs_err=max_abs(loaded[0], eager[0]),
                               witnesses=witnesses, detections=int(eager[4].sum()))
            ok = equal if tier == "int8_chain" else (
                (nms_exact and compared[b]["boxes_max_abs_err"] <= 1e-5)
                or (witnesses and all(w["margin"] is not None and w["margin"] <= NEAR_TIE
                                      for w in witnesses)))
            if not ok:
                raise AssertionError(f"{tier} B={b}: the loaded program disagrees with the "
                                     f"eager predictor {compared[b]}")
        row = child_rows[os.path.basename(path)]
        tiers[tier].update(fresh_process=row, loaded_vs_eager=compared)
        if row["launches_b16"] != want_launches[tier]:
            raise AssertionError(f"{tier}: the loaded B=16 call in its own process launched "
                                 f"{row['launches_b16']}, expected {want_launches[tier]}")

    # A2: the fp32 program loaded in a process of its own was index-exact
    # with eager, not bit-equal (8.9e-7 apart). Loaded in THIS process (the
    # same cuDNN state as eager), and loaded in a process of its own with
    # cuDNN's algorithm choice pinned on both sides
    fp32_trace = {}
    loaded, _ = aot.load_detector_artifact(paths["fp32"])
    with torch.inference_mode():
        here, eager = loaded(batch16), predictors["fp32"](batch16)
    fp32_trace["loaded_here"] = dict(bit_equal=all(torch.equal(a, b) for a, b in zip(here, eager)),
                                     boxes_max_abs_err=max_abs(here[0], eager[0]))
    fp32_trace["own_process_default"] = dict(
        bit_equal=tiers["fp32"]["loaded_vs_eager"][16]["bit_equal"],
        boxes_max_abs_err=tiers["fp32"]["loaded_vs_eager"][16]["boxes_max_abs_err"])
    del loaded, here
    cudnn_pinned(True)
    try:
        child_pinned = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--load-artifact", "--deterministic",
             inputs, paths["fp32"]], capture_output=True, text=True, timeout=600)
        if child_pinned.returncode != 0:
            raise AssertionError(f"the pinned artifact process failed (rc "
                                 f"{child_pinned.returncode}): {child_pinned.stderr[-3000:]}")
        got = np.load(f"{paths['fp32']}.out.npz")
        eager_there = np.load(f"{paths['fp32']}.eager.npz")
        there = json.loads(child_pinned.stdout.strip().splitlines()[-1])[
            os.path.basename(paths["fp32"])]
        fp32_trace["own_process_pinned_eager_equals_loaded"] = there["eager_equals_loaded_here"]
        with torch.inference_mode():
            pinned = {b: [t.cpu() for t in predictors["fp32"](batch16[:b])]
                      for b in ARTIFACT_BATCHES}
    finally:
        cudnn_pinned(False)
    for b in ARTIFACT_BATCHES:
        loaded_b = [torch.from_numpy(got[f"{name}_{b}"]) for name in NMS_OUTPUTS]
        there_b = [torch.from_numpy(eager_there[f"{name}_{b}"]) for name in NMS_OUTPUTS]
        fp32_trace[f"own_process_pinned_b{b}"] = dict(
            bit_equal=all(torch.equal(a, e) for a, e in zip(loaded_b, pinned[b])),
            boxes_max_abs_err=max_abs(loaded_b[0], pinned[b][0]),
            eager_there_vs_eager_here=max_abs(there_b[0], pinned[b][0]))
    tiers["fp32"]["a2_trace"] = fp32_trace
    log(f"artifact fp32 trace (cuDNN default vs pinned) {json.dumps(fp32_trace)}")

    # this process: the loaded program's launches, and eager against loaded
    counts = {}
    for tier, path in paths.items():
        t0 = time.monotonic()
        loaded, _ = aot.load_detector_artifact(path)
        load_s = time.monotonic() - t0
        loaded(batch16)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        loaded(batch16)
        torch.cuda.synchronize()
        counts[tier] = {k: w.launches for k, w in wrappers.items()}
        if counts[tier] != want_launches[tier]:
            raise AssertionError(f"{tier}: one loaded B=16 call launched {counts[tier]}, "
                                 f"expected {want_launches[tier]}")
        turns = {"eager": dict(ms=[], device_ms=[]), "loaded": dict(ms=[], device_ms=[])}
        for name in ("eager", "loaded", "loaded", "eager"):
            fn = predictors[tier] if name == "eager" else loaded
            turns[name]["ms"].append(cuda_ms(lambda: fn(batch16), 5))
            profiled = device_time_by_kernel(lambda: fn(batch16))
            turns[name]["device_ms"].append(profiled[0] if profiled else None)
        tiers[tier].update(load_s_here=load_s, launches_b16=counts[tier], b16_turns=turns)
        log(f"artifact {tier} loaded here {json.dumps(dict(load_s=load_s, b16_turns=turns))}")
        del loaded
    del predictors
    torch.cuda.empty_cache()

    host = op_host_cost(nms_kernel, conv1x1)
    log(f"op host cost {json.dumps(host)}")

    # int8_chain served from its model keys and from its artifact (Serve's
    # artifact: key), in turns: keys, artifact, artifact, keys
    _, keys_app, keys_setup_s = tier_app("int8_chain", inference_app, serve_app)
    t0 = time.monotonic()
    httpd, artifact_app = serve_app.Serve()(artifact=paths["int8_chain"], port=0,
                                            batch_buckets=(1, 4, 16), batch_timeout_ms=5,
                                            serve_forever=False)
    artifact_setup_s = time.monotonic() - t0
    serve_rows = []
    try:
        health = artifact_app.health()
        for name in ("int8_chain", "artifact int8_chain", "artifact int8_chain", "int8_chain"):
            app, setup_s = ((keys_app, keys_setup_s) if name == "int8_chain"
                            else (artifact_app, artifact_setup_s))
            serve_rows.append(closed_loop(app, name, bodies, setup_s))
    finally:
        keys_app.shutdown()
        artifact_app.shutdown()
        httpd.server_close()
    if health["quantize"] != "int8_chain" or health["classes"] != 80:
        raise AssertionError(f"the artifact server reports {health}")
    row = dict(card=smi, tiers=tiers, fresh_process_s=child_s, op_host_cost=host,
               serve=serve_rows)
    return row, counts


DP_DIR = os.path.join(ROOT, "build", "smoke_dp")
DP_BATCH = 16  # the global batch of phase 24: 2 ranks × 8, or 1 × 16


def dp_model(device, dtype=torch.float32):
    """The seeded YOLOv3-416 of phases 14 and 15 (3 shapes_toy classes) on
    ``device`` → (spec, params, BN state, anchors, head grids)."""
    from yolov3_tpu_torch import models
    from yolov3_tpu_torch.config import get_anchors, read_class_names
    from yolov3_tpu_torch.models.network import head_grid_sizes, to_device

    files = toy_training_files()
    spec = models.parse_model_config(files["model"], len(read_class_names(files["names"])))
    params, state = models.init_model(spec, torch.Generator().manual_seed(0))
    return (spec, to_device(params, device, dtype), to_device(state, device, dtype),
            get_anchors(files["anchors"]), head_grid_sizes(spec, 416))


def dp_inputs():
    """Phase 15's data: the first 16 shapes_toy training images at 416² and
    their labels, written to ``build/smoke_dp/inputs.npz`` for the ranks."""
    from yolov3_tpu_torch.data.tfrecord import parse_tfrecords

    files = toy_training_files()
    examples = list(parse_tfrecords(files["train"], 416, 100, files["names"]))[:DP_BATCH]
    images = np.stack([e[0] for e in examples]).astype(np.float32)
    labels = np.stack([e[1] for e in examples]).astype(np.float32)
    os.makedirs(DP_DIR, exist_ok=True)
    path = os.path.join(DP_DIR, "inputs.npz")
    np.savez(path, images=images, labels=labels)
    return path, images, labels


def k5_counts():
    from yolov3_tpu_torch.ops.cuda import bn_stats

    return dict(forward=bn_stats.bn_sums.launches, backward=bn_stats.bn_moments_dx.launches,
                sync_forward=bn_stats.bn_sums.sync_launches,
                sync_backward=bn_stats.bn_moments_dx.sync_launches)


def reset_k5_counts():
    from yolov3_tpu_torch.ops.cuda import bn_stats

    bn_stats.bn_sums.launches = bn_stats.bn_moments_dx.launches = 0
    bn_stats.bn_sums.sync_launches = bn_stats.bn_moments_dx.sync_launches = 0


def state_digest(state):
    """sha256 of every leaf of a train state, in sorted-key order."""
    import hashlib

    from yolov3_tpu_torch.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(state):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_worker(mode, rank, world, port, inputs):
    """``python3 chip_smoke.py --dp-worker <mode> <rank> <world> <port>
    <inputs.npz>``, a rank that phase 24 starts. ``gloo``: one of two ranks
    on the one card, joined over gloo: the data-parallel gradient of its 8
    images (sync-BN, the coalesced mean) written by rank 0 to
    ``dp_grads.npz``, then one DP train step (Adam, EMA) whose state's digest
    it prints. ``nccl``: world size 1 over NCCL, the plain step and the DP
    step in turns from one state (bit-equal), ms a step by host clock and
    the device's busy ms (profiler), and the time of the coalesced 248 MB
    gradient all-reduce and of one step's 72 per-layer BN all-reduces (CUDA
    events). Prints one JSON line."""
    import torch.distributed as dist

    from yolov3_tpu_torch.device import pin_fp32_ieee, resolve_device
    from yolov3_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from yolov3_tpu_torch.parallel.train_step import (init_train_state, loss_and_grads,
                                                      make_adam, make_train_step)
    from yolov3_tpu_torch.tree import tree_leaves, tree_unflatten

    rank, world = int(rank), int(world)
    initialize_multihost(f"127.0.0.1:{port}", world, rank,
                         backend="nccl" if mode == "nccl" else "gloo")
    try:
        dev = resolve_device(None)
        pin_fp32_ieee(dev)
        spec, params, state, anchors, grids = dp_model(dev)
        if mode == "gloo-spatial":  # phase 25 (c): this rank's images in two bands
            return spatial_rank(spec, params, state, anchors, grids, dev, inputs, rank, world)
        mesh = make_mesh(devices=(dev,))
        rows = mesh.local_slice(DP_BATCH)
        data = np.load(inputs)
        images = torch.from_numpy(data["images"][rows]).to(dev)
        labels = torch.from_numpy(data["labels"][rows]).to(dev)
        optimizer = make_adam(1e-3)
        row = dict(mode=mode, rank=rank, world=world, device=str(dev), rows=[rows.start, rows.stop])
        if mode == "gloo":
            reset_k5_counts()
            grads, bn, metrics = loss_and_grads(spec, params, state, images, labels, anchors,
                                                grids, DP_BATCH // world, bn_group=mesh.group)
            grads = tree_unflatten(grads, mesh.all_reduce_mean(tree_leaves(grads)))
            metrics = tree_unflatten(metrics, mesh.all_reduce_mean(tree_leaves(metrics)))
            torch.cuda.synchronize()
            row["grad_counts"] = k5_counts()
            if rank == 0:  # leaves in tree_paths order
                np.savez(os.path.join(DP_DIR, "dp_grads.npz"),
                         **{f"grad{i}": v.cpu().numpy()
                            for i, (_, v) in enumerate(tree_paths(grads))},
                         **{f"bn{i}": v.cpu().numpy() for i, (_, v) in enumerate(tree_paths(bn))},
                         terms=metrics["per_grid_per_source"].cpu().numpy(),
                         total_loss=metrics["total_loss"].cpu().numpy())
            del grads, bn
            step = make_train_step(spec, anchors, grids, DP_BATCH, optimizer, mesh=mesh,
                                   ema_decay=0.999)
            t0 = time.perf_counter()
            new, m = step(init_train_state(params, state, optimizer, ema=True), images, labels)
            torch.cuda.synchronize()
            row.update(step_s=time.perf_counter() - t0, loss=float(m["total_loss"]),
                       counts=k5_counts(), digest=state_digest(new))
        else:
            # bit-equal needs every kernel of the step deterministic: cuDNN's
            # algorithms pinned, PyTorch's deterministic kernels where it has
            # them (the ops without one are reported)
            import warnings

            cudnn_pinned(True)
            torch.use_deterministic_algorithms(True, warn_only=True)
            plain = make_train_step(spec, anchors, grids, DP_BATCH, optimizer)
            dp = make_train_step(spec, anchors, grids, DP_BATCH, optimizer, mesh=mesh)
            start = init_train_state(params, state, optimizer)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                outs = [fn(start, images, labels) for fn in (plain, plain, dp)]

            def same(x, y):
                return all(torch.equal(a, b) for u, v in zip(x, y)
                           for a, b in zip(tree_leaves(u), tree_leaves(v)))

            row.update(plain_repeat_bit_equal=same(outs[0], outs[1]),
                       bit_equal=same(outs[0], outs[2]),
                       nondeterministic_ops=sorted({str(w.message)[:120] for w in caught}))
            torch.use_deterministic_algorithms(False)  # the times below: PyTorch's defaults
            cudnn_pinned(False)
            reset_k5_counts()
            dp(start, images, labels)
            torch.cuda.synchronize()
            row["counts_one_step"] = k5_counts()
            turns = {"plain": dict(ms=[], device_ms=[]), "dp": dict(ms=[], device_ms=[])}
            for name in ("plain", "dp", "dp", "plain"):
                fn = plain if name == "plain" else dp
                fn(start, images, labels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    fn(start, images, labels)
                torch.cuda.synchronize()
                turns[name]["ms"].append((time.perf_counter() - t0) * 1e3 / 3)
                profiled = device_time_by_kernel(lambda: fn(start, images, labels))
                turns[name]["device_ms"].append(profiled[0] if profiled else None)
            row["turns"] = turns
            flat = tree_leaves(start["params"])
            row["grad_bytes"] = sum(t.numel() * t.element_size() for t in flat)
            row["grad_all_reduce_ms"] = cuda_ms(lambda: mesh.all_reduce_mean(flat), 10)
            channels = [v["mean"].numel() for _, v in
                        ((k, e) for sm in start["bn_state"].values() for k, e in sm.items())]
            sums = [torch.zeros((2, c), device=dev) for c in channels]
            row["bn_layers"] = len(channels)
            row["bn_all_reduces_ms"] = cuda_ms(
                lambda: [dist.all_reduce(t, group=mesh.group) for t in sums], 10)
        print(json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def spatial_rank(spec, params, state, anchors, grids, dev, inputs, rank, world):
    """A rank of phase 25 (c): one Adam step of a (data ``world`` × spatial
    2) mesh, this rank's 8 images in two bands on its card; prints the
    state's digest and K5's counts as one JSON line."""
    from yolov3_tpu_torch.parallel.mesh import make_mesh
    from yolov3_tpu_torch.parallel.train_step import init_train_state, make_adam, make_train_step

    mesh = make_mesh(devices=(dev, dev), spatial=2)
    rows = mesh.local_slice(DP_BATCH)
    data = np.load(inputs)
    images = torch.from_numpy(data["images"][rows]).to(dev)
    labels = torch.from_numpy(data["labels"][rows]).to(dev)
    optimizer = make_adam(1e-3)
    step = make_train_step(spec, anchors, grids, DP_BATCH, optimizer, mesh=mesh)
    reset_k5_counts()
    t0 = time.perf_counter()
    new, m = step(init_train_state(params, state, optimizer), images, labels)
    torch.cuda.synchronize()
    print(json.dumps(dict(mode="gloo-spatial", rank=rank, world=world, mesh=mesh.shape,
                          step_s=time.perf_counter() - t0, loss=float(m["total_loss"]),
                          counts=k5_counts(), digest=state_digest(new))), flush=True)
    return 0


def run_dp_ranks(mode, world, inputs):
    """Start ``world`` ranks of ``dp_worker`` and wait for them (a rank that
    fails fails the phase) → their JSON rows."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    # cuBLAS's deterministic workspace, for (b)'s bit-equality
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", mode,
                               str(rank), str(world), port, inputs],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for rank in range(world)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{mode} rank {rank} failed (rc {p.returncode}): {err[-3000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


class _ShardedMoments(torch.autograd.Function):
    """K5 as two data-parallel ranks compute it, in one process: the sums of
    each half of the batch (one launch each), added as the all-reduce adds
    them, the global mean and var by the wrapper's expression, and K5's
    backward over the whole batch with the global count. Phase 24's
    reference for the DP gradient: BatchNorm's one-pass variance makes this
    seeded init's gradient depend on the order of the statistics' sums
    (tests/test_torch_parallel.py), so the reference takes them in the
    ranks' order."""

    @staticmethod
    def forward(ctx, x):
        from yolov3_tpu_torch.ops.cuda import bn_stats

        halves = [bn_stats.bn_sums(part) for part in x.chunk(2)]
        s, s2 = (a + b for a, b in zip(*halves))
        n = x.numel() // x.shape[1]
        mean = s / n
        ctx.save_for_backward(x, mean)
        ctx.n = n
        return mean, torch.clamp(s2 / n - mean * mean, min=0.0)

    @staticmethod
    def backward(ctx, dmean, dvar):
        from yolov3_tpu_torch.ops.cuda import bn_stats

        x, mean = ctx.saved_tensors
        return bn_stats.bn_moments_dx(x, mean, dmean, dvar, ctx.n)


def phase_dp(inference_app, serve_app, nms_kernel, conv1x1, conv_int8, resblock, bodies, smi):
    """Phase 24: data parallelism on the card, the seeded YOLOv3-416 (3
    classes, 416², fp32 IEEE) on phase 15's first 16 shapes_toy images.

    (a) two ranks on cuda:0 over gloo, 8 images each: the DP step against
    one process's over all 16 on the card — loss terms 1e-4 relative (floor
    10), new BN state 1e-4 · max(1, |value|); the DP gradient within 2e-4 of
    each leaf's largest |value| of one process's whose BatchNorm sums are
    taken per half and added (``_ShardedMoments``, the ranks' order); the
    distances of the DP gradient, of the plain single process's and of the
    per-half one from a float64 run on the card (phase 14's referee),
    printed; both ranks' state after a DP step (params, BN state, Adam's
    moments, EMA) bit-identical; K5 launched and one sync all-reduce each
    way per BN layer. (b) world size 1 over NCCL: the DP
    step bit-equal to the plain step, their ms in turns, the all-reduces'
    ms. (c) ``make_predictor(mesh=)`` over ("cuda:0", "cuda:0") at B=16 in
    fp32 and ``int8_chain`` against the single predictor (NMS index-exact,
    boxes 1e-5), K1, K3, K4 and K6 launched, no host sync inside a sharded
    call (``torch.cuda.set_sync_debug_mode``, which PyTorch calls a
    prototype that does not see every sync); ``Serve`` with
    ``data_parallel: true`` on the one card logs the no-op and answers as
    the plain server. → (row, K5 launches {forward, backward, sync_forward,
    sync_backward} summed over every rank of (a) and (b), the serving
    kernels' launches of (c))."""
    from yolov3_tpu_torch.models import layers
    from yolov3_tpu_torch.ops.cuda import bias_act
    from yolov3_tpu_torch.parallel.mesh import Mesh
    from yolov3_tpu_torch.parallel.train_step import loss_and_grads

    inputs, images_np, labels_np = dp_inputs()
    row = dict(card=smi)

    # (a) one process over the 16 images on the card, and float64 on the card
    spec, params, state, anchors, grids = dp_model("cuda")
    images, labels = torch.from_numpy(images_np).cuda(), torch.from_numpy(labels_np).cuda()
    grads, bn, metrics = loss_and_grads(spec, params, state, images, labels, anchors, grids,
                                        DP_BATCH)
    single = dict(grads={k: v.double().cpu() for k, v in tree_paths(grads)},
                  bn={k: v.cpu() for k, v in tree_paths(bn)},
                  terms=metrics["per_grid_per_source"].cpu())
    kernel_moments, layers.bn_moments = layers.bn_moments, _ShardedMoments.apply
    try:
        grads = loss_and_grads(spec, params, state, images, labels, anchors, grids, DP_BATCH)[0]
    finally:
        layers.bn_moments = kernel_moments
    halves = {k: v.double().cpu() for k, v in tree_paths(grads)}
    del grads, bn

    def moments64(x, group=None):  # plain float64 statistics: no kernel, no f32 sums
        mean = x.mean(dim=(0, 2, 3))
        return mean, torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)

    p64, s64 = dp_model("cuda", torch.float64)[1:3]
    kernel_moments, layers.bn_moments = layers.bn_moments, moments64
    try:
        g64 = loss_and_grads(spec, p64, s64, images.double(), labels, anchors, grids,
                             DP_BATCH)[0]
    finally:
        layers.bn_moments = kernel_moments
    ref64 = {k: v.cpu() for k, v in tree_paths(g64)}
    del p64, s64, g64
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks = run_dp_ranks("gloo", 2, inputs)
    gloo_s = time.monotonic() - t0
    dp = np.load(os.path.join(DP_DIR, "dp_grads.npz"))
    dp_grads = {k: torch.from_numpy(dp[f"grad{i}"]).double()
                for i, k in enumerate(single["grads"])}
    terms = torch.from_numpy(dp["terms"])
    term_err = float(((terms - single["terms"]).abs()
                      / single["terms"].abs().clamp(min=10.0)).max())
    bn_err = max(float(((torch.from_numpy(dp[f"bn{i}"]) - v).abs() / v.abs().clamp(min=1.0)).max())
                 for i, v in enumerate(single["bn"].values()))

    def leaf_errors(got, want):
        return sorted(((float((got[k] - want[k]).abs().max())
                        / max(float(want[k].abs().max()), 1e-12), k) for k in want),
                      reverse=True)

    median = lambda errs: errs[len(errs) // 2][0]  # noqa: E731
    dp_single, dp_halves = leaf_errors(dp_grads, single["grads"]), leaf_errors(dp_grads, halves)
    dp64, single64 = leaf_errors(dp_grads, ref64), leaf_errors(single["grads"], ref64)
    halves64 = leaf_errors(halves, ref64)
    # a leaf off the per-half reference by more than 2e-4 must be one that
    # one process in fp32 gets no closer to float64: within twice the
    # distance of the nearer of the two single-process gradients
    far = {k: e for e, k in dp_halves if e > 2e-4}
    by = lambda errs: {k: e for e, k in errs}  # noqa: E731
    d64, s64_, h64 = by(dp64), by(single64), by(halves64)
    ill = {k: dict(dp_vs_halves=e, dp_vs_float64=d64[k], single_vs_float64=s64_[k],
                   halves_vs_float64=h64[k]) for k, e in far.items()}
    grads_ok = all(d64[k] <= max(2 * min(s64_[k], h64[k]), 2e-4) for k in far)
    want_counts = dict(forward=144, backward=144, sync_forward=144, sync_backward=144)
    row["a_two_ranks_gloo"] = dict(
        ranks=ranks, seconds=gloo_s, loss_terms_max_rel_err=term_err,
        bn_state_max_rel_err=bn_err, grad_leaves=len(dp_single),
        grad_dp_vs_halves=dict(worst=dp_halves[0][0], median=median(dp_halves),
                               worst_leaves=[[k, e] for e, k in dp_halves[:3]]),
        grad_dp_vs_single=dict(worst=dp_single[0][0], median=median(dp_single),
                               worst_leaves=[[k, e] for e, k in dp_single[:3]]),
        grad_vs_float64=dict(dp_worst=dp64[0][0], single_worst=single64[0][0],
                             halves_worst=halves64[0][0], dp_median=median(dp64),
                             single_median=median(single64), halves_median=median(halves64)),
        leaves_beyond_2e4=ill,
        ranks_bit_identical=ranks[0]["digest"] == ranks[1]["digest"])
    log(f"dp (a) two ranks over gloo {json.dumps(row['a_two_ranks_gloo'])}")
    if not (term_err <= 1e-4 and bn_err <= 1e-4 and grads_ok
            and ranks[0]["digest"] == ranks[1]["digest"]):
        raise AssertionError(f"phase 24 (a): the DP step disagrees: {row['a_two_ranks_gloo']}")
    for r in ranks:
        if r["counts"] != want_counts or r["grad_counts"] != {k: v // 2 for k, v in
                                                                   want_counts.items()}:
            raise AssertionError(f"phase 24 (a): rank {r['rank']} launched K5 / synced "
                                 f"{r['counts']}, expected {want_counts} (72 BN layers, "
                                 "one gradient then one step)")
    del single, halves, ref64, dp_grads
    torch.cuda.empty_cache()

    # (b) world size 1 over NCCL
    t0 = time.monotonic()
    (nccl,) = run_dp_ranks("nccl", 1, inputs)
    nccl["seconds"] = time.monotonic() - t0
    row["b_world_one_nccl"] = nccl
    log(f"dp (b) world size 1 over NCCL {json.dumps(nccl)}")
    if not nccl["bit_equal"]:
        raise AssertionError("phase 24 (b): the DP step at world size 1 is not the plain step")
    k5 = {k: sum(r["counts"][k] for r in ranks) + nccl["counts_one_step"][k]
          for k in want_counts}

    # (c) data-parallel serving over two replicas on the one card
    model, names, anchors80 = ARTIFACT_MODEL
    mesh = Mesh((torch.device("cuda", 0), torch.device("cuda", 0)))
    batch16 = torch.from_numpy(smoke_images(bodies, 16)).cuda()
    wrappers = dict(nms_sweep=nms_kernel.suppression_sweep,
                    conv1x1_int8=conv1x1.conv1x1_int8_requant,
                    resblock_int8=resblock.fused_resblock, conv_int8=conv_int8.conv_int8,
                    bias_act=bias_act.bias_act)
    serving, serve_launches = {}, dict.fromkeys(wrappers, 0)
    nms_kw = dict(max_boxes=100, iou_threshold=0.5, score_threshold=0.1)
    from yolov3_tpu_torch.ops import nms as nms_mod

    for tier, quantize in (("fp32", None), ("int8_chain", "int8_chain")):
        kw = dict(nms_score_threshold=0.1, quantize=quantize, seed=0,
                  calibration_images_dir=CALIBRATION_DIR if quantize else None)
        one = inference_app.build_serving_predictor(model, names, anchors80, None, 416, **kw)[0]
        two = inference_app.build_serving_predictor(model, names, anchors80, None, 416, **kw,
                                                    mesh=mesh)[0]
        with torch.inference_mode():
            want = [t.cpu() for t in one(batch16)]
            two(batch16)
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            got = two(batch16)
            torch.cuda.synchronize()
            launches = {k: w.launches for k, w in wrappers.items()}
            torch.cuda.set_sync_debug_mode("warn")
            import warnings

            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                two(batch16)
                torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("default")
        got = [t.cpu() for t in got]
        nms_exact = torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
        witnesses, _, _ = compare_detections(nms_mod, got, want, nms_kw)
        serving[tier] = dict(
            bit_equal=all(torch.equal(a, b) for a, b in zip(got, want)), nms_index_exact=nms_exact,
            boxes_max_abs_err=max_abs(got[0], want[0]), detections=int(want[4].sum()),
            launches_b16=launches, host_syncs_in_a_call=len(caught),
            host_sync_sites=sorted({f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                                    for w in caught}),
            single_ms=cuda_ms(lambda: one(batch16), 5), sharded_ms=cuda_ms(lambda: two(batch16), 5))
        profiled = device_time_by_kernel(lambda: two(batch16))
        serving[tier]["sharded_device_ms"] = profiled[0] if profiled else None
        log(f"dp (c) {tier} sharded serving {json.dumps(serving[tier])}")
        ok = (nms_exact and serving[tier]["boxes_max_abs_err"] <= 1e-5) or (
            witnesses and all(w["margin"] is not None and w["margin"] <= NEAR_TIE
                              for w in witnesses))
        if not ok:
            raise AssertionError(f"phase 24 (c) {tier}: the sharded predictor disagrees with "
                                 f"the single one {serving[tier]}")
        if tier == "int8_chain" and min(launches.values()) == 0:
            raise AssertionError(f"phase 24 (c): a kernel did not launch: {launches}")
        if launches["bias_act"] != 2 * K8_A_FORWARD[tier != "fp32"]:  # a forward a replica
            raise AssertionError(f"phase 24 (c) {tier}: K8 launched {launches['bias_act']} "
                                 f"times, expected two forwards' {K8_A_FORWARD}")
        if caught:  # a host sync in a call would serialize replicas on several cards
            raise AssertionError(f"phase 24 (c) {tier}: a sharded call waits for the card at "
                                 f"{serving[tier]['host_sync_sites']}")
        for k, v in launches.items():
            serve_launches[k] += v
        del one, two
        torch.cuda.empty_cache()

    # a serve config with data_parallel: true on the one card: the no-op
    handler, root = _LogLines(), logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    cfg = dict(model_config_file=os.path.join(ROOT, "config/models/yolov3_tiny/model.yaml"),
               classes_name_file=os.path.join(ROOT, "datasets/shapes_toy/class.names"),
               anchors_file=os.path.join(ROOT, "datasets/shapes_toy/anchors/anchors_tiny.txt"),
               input_weights_path=os.path.join(ROOT, "checkpoints/output/yolov3_train_tiny.tf"),
               image_size=416, nms_score_threshold=0.1, port=0, batch_buckets=(1, 4),
               serve_forever=False, warmup=False)
    answers = []
    try:
        for parallel in (False, True):
            httpd, app = serve_app.Serve()(**cfg, data_parallel=parallel)
            try:
                answers.append(app.detect(bodies[0])["detections"])
            finally:
                app.shutdown()
                httpd.server_close()
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    noop = [line for line in handler.lines if "data_parallel: one cuda device, a no-op" in line]
    same = (len(answers[0]) == len(answers[1]) > 0 and all(
        a["class_id"] == b["class_id"] and abs(a["score"] - b["score"]) <= 1e-5
        and max(abs(u - v) for u, v in zip(a["box_normalized"], b["box_normalized"])) <= 1e-5
        for a, b in zip(*answers)))
    row["c_serving"] = dict(tiers=serving, serve_data_parallel_noop_logged=bool(noop),
                            serve_answers_equal=same, serve_detections=len(answers[0]))
    if not (noop and same):
        raise AssertionError(f"phase 24 (c): serve with data_parallel on one card: "
                             f"{row['c_serving']}")
    return row, k5, serve_launches


SP_DIR = os.path.join(ROOT, "build", "smoke_spatial")


class _BandMoments(torch.autograd.Function):
    """K5 as a spatial split over ``bands`` bands of a 416² image computes
    it, in one unsharded forward: each band's rows (their coarse rows of the
    13-row grid, ``spatial.coarse_rows``) summed by one launch, the sums
    added in band order, mean and var over the whole count, and K5's
    backward with that count. Phase 25 (b)'s reference: BatchNorm's
    one-pass variance makes the gradient depend on the order of the
    statistics' sums, so the reference takes them in the bands' order."""

    @staticmethod
    def forward(ctx, x, bands=None):
        from yolov3_tpu_torch.ops.cuda import bn_stats
        from yolov3_tpu_torch.parallel import spatial as sp

        unit = x.shape[2] // 13
        rows = [r * unit for r in sp.coarse_rows(13, bands or SP_BANDS) if r]
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               and not x.is_contiguous() else torch.contiguous_format)  # x's own, as a band's
        sums = [torch.stack(bn_stats.bn_sums(part.contiguous(memory_format=fmt)))
                for part in x.split(rows, 2)]
        s, s2 = sum(sums[1:], sums[0])
        n = x.numel() // x.shape[1]
        mean = s / n
        ctx.save_for_backward(x, mean)
        ctx.n = n
        return mean, torch.clamp(s2 / n - mean * mean, min=0.0)

    @staticmethod
    def backward(ctx, dmean, dvar):
        from yolov3_tpu_torch.ops.cuda import bn_stats

        x, mean = ctx.saved_tensors
        return bn_stats.bn_moments_dx(x, mean, dmean, dvar, ctx.n), None


SP_BANDS = 2  # phase 25 (b): the training split


def sp_counts(wrappers, resblock):
    return dict({k: w.launches for k, w in wrappers.items()},
                resblock_int8_band_edge=resblock.fused_resblock.edge_launches)


def spatial_train_check(bn_stats, resblock, wrappers, reset):
    """Phase 25 (b): one training step of YOLOv3-416 (3 classes, B=16, fp32
    IEEE) over ``SP_BANDS`` bands of the card, against the unsharded step
    whose K5 sums are taken per band (``_BandMoments``): loss 1e-5 relative,
    BN state 1e-4, and every gradient leaf no farther from the float64 step
    than the larger of 2e-4 of its largest entry and twice the fp32 order
    noise there: the farthest of three unsharded fp32 steps from float64,
    K5's sums per band over the two bands, over four, and whole (the fp32
    gradient at this init moves with the order of its sums, one sample of
    which says little about a leaf); the float64 step over the same bands
    (plain float64 statistics) within 2e-4 of the unsharded float64 step at
    every leaf.
    K5's launches each way; ms a step and peak GB of the spatial and the
    plain step. → (row, the kernels' launches of the spatial step)."""
    from yolov3_tpu_torch.models import layers
    from yolov3_tpu_torch.parallel import spatial as sp
    from yolov3_tpu_torch.parallel.mesh import make_mesh
    from yolov3_tpu_torch.parallel.train_step import (init_train_state, loss_and_grads,
                                                      make_adam, make_train_step)

    cuda0 = torch.device("cuda", 0)
    _, images_np, labels_np = dp_inputs()
    spec, params, state, anchors, grids = dp_model("cuda")
    images, labels = torch.from_numpy(images_np).cuda(), torch.from_numpy(labels_np).cuda()
    bands = (cuda0,) * SP_BANDS
    reset()
    grads, bn, metrics = loss_and_grads(spec, params, state, images, labels, anchors, grids,
                                        DP_BATCH, bands=bands)
    torch.cuda.synchronize()
    k5 = dict(forward=bn_stats.bn_sums.launches, backward=bn_stats.bn_moments_dx.launches)
    counts = sp_counts(wrappers, resblock)
    got = dict(grads={k: v.double().cpu() for k, v in tree_paths(grads)},
               bn={k: v.cpu() for k, v in tree_paths(bn)},
               loss=float(metrics["total_loss"]))
    del grads, bn
    noise = {}  # the unsharded fp32 step, K5's sums in three orders
    kernel_moments = layers.bn_moments
    for name, moments in (("bands2", lambda x, group=None: _BandMoments.apply(x, SP_BANDS)),
                          ("bands4", lambda x, group=None: _BandMoments.apply(x, 4)),
                          ("whole", kernel_moments)):
        layers.bn_moments = moments
        try:
            grads, bn, metrics = loss_and_grads(spec, params, state, images, labels, anchors,
                                                grids, DP_BATCH)
        finally:
            layers.bn_moments = kernel_moments
        noise[name] = {k: v.double().cpu() for k, v in tree_paths(grads)}
        if name == "bands2":
            ref = dict(grads=noise[name], bn={k: v.cpu() for k, v in tree_paths(bn)},
                       loss=float(metrics["total_loss"]))
        del grads, bn

    def leaf_errors(a, b):
        return {k: float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-12)
                for k in b}

    # the referee, in float64 on the card with plain float64 statistics: the
    # unsharded step, and the spatial step over the same two bands; the band
    # math itself must hold there, where reordering costs nothing
    def moments64(x, group=None):
        mean = x.mean(dim=(0, 2, 3))
        return mean, torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)

    def band_moments64(xs, group=None):
        n = sum(x.numel() // x.shape[1] for x in xs)
        mean = sum(x.sum(dim=(0, 2, 3)) for x in xs) / n
        return mean, torch.clamp(sum((x * x).sum(dim=(0, 2, 3)) for x in xs) / n
                                 - mean * mean, min=0.0)

    p64, s64 = dp_model("cuda", torch.float64)[1:3]
    g64 = {}
    kernel_moments, layers.bn_moments = layers.bn_moments, moments64
    band_moments, sp.bn_moments_bands = sp.bn_moments_bands, band_moments64
    try:
        for name, kw in (("plain", {}), ("spatial", dict(bands=bands))):
            g64[name] = {k: v.cpu() for k, v in tree_paths(loss_and_grads(
                spec, p64, s64, images.double(), labels, anchors, grids, DP_BATCH, **kw)[0])}
    finally:
        layers.bn_moments, sp.bn_moments_bands = kernel_moments, band_moments
    del p64, s64

    def worst_median(e):
        v = sorted(e.values())
        return dict(worst=v[-1], median=v[len(v) // 2], worst_leaf=max(e, key=e.get))

    errs = leaf_errors(got["grads"], ref["grads"])
    spatial64 = leaf_errors(got["grads"], g64["plain"])
    orders64 = {name: leaf_errors(g, g64["plain"]) for name, g in noise.items()}
    envelope = {k: max(e[k] for e in orders64.values()) for k in spatial64}
    float64_band_math = leaf_errors(g64["spatial"], g64["plain"])
    # fp32: each leaf no farther from float64 than twice the unsharded
    # steps' order noise there (the convolutions' own reductions over bands
    # reorder fp32 sums as BatchNorm's order does, PERF.md §6); the band
    # math exact in float64
    margin = {k: spatial64[k] / max(2e-4, 2 * envelope[k]) for k in spatial64}
    distances = dict(spatial_vs_reference=worst_median(errs),
                     spatial_vs_float64=worst_median(spatial64),
                     **{f"{name}_vs_float64": worst_median(e) for name, e in orders64.items()},
                     float64_spatial_vs_float64=worst_median(float64_band_math),
                     spatial64_over_its_bound=worst_median(margin),
                     leaves_over_twice_bands2=sum(spatial64[k] > max(2e-4, 2 * orders64[
                         "bands2"][k]) for k in spatial64))
    worst_leaf = distances["spatial64_over_its_bound"]["worst_leaf"]
    distances["at_that_leaf"] = dict(spatial_vs_float64=spatial64[worst_leaf],
                                     **{f"{name}_vs_float64": e[worst_leaf]
                                        for name, e in orders64.items()})
    grads_ok = (distances["float64_spatial_vs_float64"]["worst"] <= 2e-4
                and distances["spatial64_over_its_bound"]["worst"] <= 1.0)
    loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    bn_err = max(float(((got["bn"][k] - v).abs() / v.abs().clamp(min=1.0)).max())
                 for k, v in ref["bn"].items())
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    train = dict(loss=got["loss"], loss_rel_err=loss_err, bn_state_max_rel_err=bn_err,
                 grad_worst_leaves=worst[:3], grad_distances=distances, k5_launches=k5,
                 leaves=len(errs))
    os.makedirs(SP_DIR, exist_ok=True)
    with open(os.path.join(SP_DIR, "train_leaves.json"), "w") as f:
        json.dump(dict(spatial_vs_float64=spatial64, spatial_vs_reference=errs,
                       float64_spatial_vs_float64=float64_band_math,
                       **{f"{name}_vs_float64": e for name, e in orders64.items()}), f)
    del got, ref, g64, noise
    torch.cuda.empty_cache()
    # ms a step and peak memory, the plain step and the spatial one in turns
    optimizer = make_adam(1e-3)
    steps = dict(plain=make_train_step(spec, anchors, grids, DP_BATCH, optimizer),
                 spatial=make_train_step(spec, anchors, grids, DP_BATCH, optimizer,
                                         mesh=make_mesh(devices=bands, spatial=SP_BANDS)))
    start = init_train_state(params, state, optimizer)
    turns = {k: dict(ms=[], peak_gb=[]) for k in steps}
    for name in ("plain", "spatial", "spatial", "plain"):
        steps[name](start, images, labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps[name](start, images, labels)
        torch.cuda.synchronize()
        turns[name]["ms"].append((time.perf_counter() - t0) * 1e3)
        turns[name]["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
    train["turns"] = turns
    log(f"spatial (b) train step {json.dumps(train)}")
    if not (loss_err <= 1e-5 and bn_err <= 1e-4 and grads_ok
            and k5 == dict(forward=72 * SP_BANDS, backward=72 * SP_BANDS)):
        raise AssertionError(f"phase 25 (b): the spatial step disagrees: loss {loss_err}, BN "
                             f"{bn_err}, gradients {distances}, K5 {k5}")
    del steps, start, params, state
    torch.cuda.empty_cache()
    return train, counts


def phase_spatial(inference_app, serve_app, evaluate_app, nms_kernel, round_sweep, conv1x1,
                  conv_int8, resblock, bn_stats, bodies, smi):
    """Phase 25: the spatial axis (``parallel/spatial.py``), the bands of a
    group on the one card, ``("cuda:0",) * S``.

    (a) serving: the seeded YOLOv3-416 (80 classes) built through
    ``build_serving_predictor(mesh=make_data_parallel_mesh(B, S, …))`` at
    S = 2 and 4 against the unsharded predictor at B = 16 and 1: fp32
    detections index-exact with boxes within 1e-5 (or a near-tie witness),
    ``int8`` and ``int8_chain`` heads and detections bit-equal (the heads of
    the band forward against the whole-image forward of the same module);
    K1, K3, K4 (its band-edge launches apart) and K6 launches of one B=16
    call; event-loop ms (CUDA events) and device-busy ms (profiler) of both,
    in turns; the halo traffic of one forward (slices moved, bytes); K4
    with its halo flags against its plain version at the 52² and 13² band
    heights (bit-equal) and one 52² block's two bands against the whole
    image's launch (device µs). (b) training: YOLOv3-416, 3 classes, B=16,
    fp32 IEEE, S = 2 (``spatial_train_check``). (c) data 2 × spatial 2: two
    gloo ranks on the card (``--dp-worker gloo-spatial``), one step each on 8 images in two bands,
    the ranks' states bit-identical (sha256). (d) ``Serve`` with
    ``spatial_partitioning: 2`` answers as the plain server (trained tiny at
    416). (e) ``evaluate`` of the trained tiny at 416 with S = 2 over
    [0.004, 0.5]: counters and APs equal to the unsharded run's, K2
    launched. → (row, launches of every kernel over the phase's runs)."""
    import copy

    from yolov3_tpu_torch.export.aot import as_predict
    from yolov3_tpu_torch.models import apply_model, layers
    from yolov3_tpu_torch.ops import nms as nms_mod
    from yolov3_tpu_torch.ops.cuda import bias_act
    from yolov3_tpu_torch.ops.cuda.kernel_times import block_case, device_us
    from yolov3_tpu_torch.parallel import spatial as sp
    from yolov3_tpu_torch.parallel.mesh import make_data_parallel_mesh
    from yolov3_tpu_torch.parallel.train_step import (init_train_state, loss_and_grads,
                                                      make_adam, make_train_step)

    os.makedirs(SP_DIR, exist_ok=True)
    cuda0 = torch.device("cuda", 0)
    wrappers = dict(nms_sweep=nms_kernel.suppression_sweep,
                    conv1x1_int8=conv1x1.conv1x1_int8_requant,
                    resblock_int8=resblock.fused_resblock, conv_int8=conv_int8.conv_int8,
                    round_sweep=round_sweep.round_sweep, bn_stats=bn_stats.bn_sums,
                    bias_act=bias_act.bias_act)
    total = dict.fromkeys(wrappers, 0)

    def reset():
        for w in wrappers.values():
            w.launches = 0
        resblock.fused_resblock.edge_launches = 0
        bn_stats.bn_moments_dx.launches = 0

    def add(counts):
        for k in total:
            total[k] += counts[k]

    row = dict(card=smi)
    nms_kw = dict(max_boxes=100, iou_threshold=0.5, score_threshold=0.1)
    model, names, anchors80 = ARTIFACT_MODEL
    batch16 = torch.from_numpy(smoke_images(bodies, 16)).cuda()
    serving = {}
    for tier, quantize in (("fp32", None), ("int8", "int8"), ("int8_chain", "int8_chain")):
        kw = dict(nms_score_threshold=0.1, quantize=quantize, seed=0,
                  calibration_images_dir=CALIBRATION_DIR if quantize else None)
        one = inference_app.build_serving_predictor(model, names, anchors80, None, 416, **kw)[0]
        two = inference_app.build_serving_predictor(
            model, names, anchors80, None, 416, **kw,
            mesh=make_data_parallel_mesh(16, 2, (cuda0, cuda0)))[0]
        for spatial in (2, 4):
            if spatial == 4:  # the same params in four bands (no second calibration)
                det = copy.deepcopy(two.module)
                det.bands = (cuda0,) * 4
                pred = as_predict(det, cuda0)
            else:
                pred = two
            det = pred.module
            for batch in (16, 1):
                x = batch16[:batch]
                key = f"{tier} S={spatial} B={batch}"
                with torch.inference_mode():
                    want = [t.cpu() for t in one(x)]
                    pred(x)
                    torch.cuda.synchronize()
                    reset()
                    got = pred(x)
                    torch.cuda.synchronize()
                    launches = sp_counts(wrappers, resblock)
                    sp.reset_halo_counts()
                    band_heads = apply_model(det.spec, det.tree("params"), {}, x,
                                             devices=det.bands)
                    halo = dict(sp.HALO)
                    heads = apply_model(det.spec, det.tree("params"), {}, x)
                    heads_equal = all(torch.equal(a, b) for a, b in zip(band_heads, heads))
                    heads_err = max(max_abs(a, b) for a, b in zip(band_heads, heads))
                    del band_heads, heads
                got = [t.cpu() for t in got]
                exact = all(torch.equal(a, b) for a, b in zip(got, want))
                witnesses, box_err, _ = compare_detections(nms_mod, got, want, nms_kw)
                r = dict(bit_equal=exact, heads_bit_equal=heads_equal, heads_max_abs=heads_err,
                         nms_index_exact=torch.equal(got[3], want[3])
                         and torch.equal(got[4], want[4]),
                         boxes_max_abs_err=box_err, witnesses=witnesses,
                         detections=int(want[4].sum()), launches=launches,
                         halo_copies=halo["copies"], halo_bytes=halo["bytes"])
                if tier != "int8" and batch == 16 or batch == 1 and tier == "fp32":
                    times = {"plain": dict(ms=[], device_ms=[]),
                             "spatial": dict(ms=[], device_ms=[])}
                    for name in ("plain", "spatial", "spatial", "plain"):
                        fn = (lambda: one(x)) if name == "plain" else (lambda: pred(x))
                        times[name]["ms"].append(cuda_ms(fn, 5))
                        profiled = device_time_by_kernel(fn)
                        times[name]["device_ms"].append(profiled[0] if profiled else None)
                        if profiled:  # where the device time goes: launches, top kernels
                            times[name]["device_launches"] = profiled[2]
                            times[name]["top_kernels_ms"] = sorted(
                                ([k[:60], v] for k, v in profiled[1].items()),
                                key=lambda kv: -kv[1])[:4]
                    r["turns"] = times
                serving[key] = r
                log(f"spatial (a) {key} {json.dumps(r)}")
                ok = exact if quantize else (
                    (r["nms_index_exact"] and box_err <= 1e-5) or (
                        witnesses and all(w["margin"] is not None and w["margin"] <= NEAR_TIE
                                          for w in witnesses)))
                if not ok or (quantize and not heads_equal):
                    raise AssertionError(f"phase 25 (a) {key}: the spatial predictor disagrees "
                                         f"with the unsharded one: {r}")
                want_k4 = 23 * spatial if tier == "int8_chain" else 0
                if (launches["resblock_int8"] != want_k4
                        or launches["bias_act"] != spatial * K8_A_FORWARD[bool(quantize)]
                        or (tier == "int8_chain" and launches["resblock_int8_band_edge"]
                            != 23 * spatial) or launches["nms_sweep"] == 0
                        or (quantize and min(launches["conv1x1_int8"],
                                             launches["conv_int8"]) == 0)):
                    raise AssertionError(f"phase 25 (a) {key}: launches {launches}")
                add(launches)
            del pred, det
        del one, two
        torch.cuda.empty_cache()
    row["a_serving"] = serving

    # K4 with its halo flags against its plain version, and a 52² block's
    # two bands (28 + 24 rows) against the whole image's launch
    k4_edges = []
    for hw, c, cuts in ((52, 256, (28, 24)), (13, 1024, (7, 6))):
        q, squeeze, expand, shortcut = block_case(16, hw, c)
        kwargs, _ = resblock.block_args(squeeze, expand, shortcut, q.scale)
        padded = torch.nn.functional.pad(q.q, (0, 0, 1, 1, 1, 1))
        whole = resblock.to_halo(q.q)
        bands, equal = [], True
        for j, (a, e) in enumerate(zip((0, cuts[0]), (cuts[0], hw))):
            xp = padded[:, a:e + 2].reshape(-1, c).contiguous()
            flags = dict(b=16, h=e - a, w=hw, halo_top=j > 0, halo_bottom=j == 0)
            got = resblock.fused_resblock(xp, **kwargs, **flags)
            equal &= torch.equal(got, resblock.fused_resblock_plain(xp, **kwargs, **flags))
            bands.append((xp, flags))
        torch.cuda.synchronize()
        whole_us = device_us(lambda: resblock.fused_resblock(whole, **kwargs, b=16, h=hw, w=hw))
        bands_us = device_us(lambda: [resblock.fused_resblock(xp, **kwargs, **f)
                                      for xp, f in bands])
        k4_edges.append(dict(stage=f"{hw}^2 C={c} B=16", band_rows=list(cuts),
                             equal_to_plain=equal, whole_device_us=whole_us,
                             two_bands_device_us=bands_us,
                             plans=[resblock.plan(16, f["h"], hw, c, c // 2)["band_rows"]
                                    for _, f in bands]))
        log(f"spatial K4 band edges {json.dumps(k4_edges[-1])}")
        if not equal:
            raise AssertionError(f"phase 25: K4 with halo flags differs from its plain version "
                                 f"{k4_edges[-1]}")
    row["k4_band_edges"] = k4_edges
    del q, padded, whole, bands
    # K5 over bands (bn_moments_bands) against its plain version: a B=16
    # 52² activation of C=256 in two bands, channels-last as the convs give it
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(16, 256, 52, 52) * 2 + rng.randn(1, 256, 1, 1) * 3)
                         .astype(np.float32)).cuda().contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.randn(2, 256).astype(np.float32)).cuda()
    k5_bands = {}
    for name, fn in (("kernel", bn_stats.bn_moments_bands),
                     ("plain", bn_stats.bn_moments_bands_plain)):
        parts = [p.contiguous(memory_format=torch.channels_last).requires_grad_(True)
                 for p in x.split((28, 24), dim=2)]
        reset()
        mean, var = fn(parts)
        (mean @ w[0] + var @ w[1]).backward()
        torch.cuda.synchronize()
        k5_bands[name] = dict(mean=mean.detach(), var=var.detach(), dx=[p.grad for p in parts],
                              parts=[p.detach() for p in parts],
                              launches=(bn_stats.bn_sums.launches,
                                        bn_stats.bn_moments_dx.launches))
    scale = float((x * x).mean())
    x64 = x.double()
    mean64 = x64.mean(dim=(0, 2, 3))
    k5_row = dict(shape=[16, 256, 52, 52], band_rows=[28, 24],
                  launches=k5_bands["kernel"]["launches"],
                  mean_err=max_abs(k5_bands["kernel"]["mean"], k5_bands["plain"]["mean"]),
                  var_err=max_abs(k5_bands["kernel"]["var"], k5_bands["plain"]["var"]),
                  mean_err_float64=max_abs(k5_bands["kernel"]["mean"].double(), mean64),
                  # dx: the plain backward at the kernel's own mean and the bands' count
                  dx_equal=all(torch.equal(g, bn_stats.bn_moments_dx_plain(
                      p, k5_bands["kernel"]["mean"], w[0], w[1], x.numel() // 256))
                      for g, p in zip(k5_bands["kernel"]["dx"], k5_bands["kernel"]["parts"])))
    row["k5_bands"] = k5_row
    log(f"spatial K5 over bands {json.dumps(k5_row)}")
    if not (k5_row["launches"] == (2, 2) and k5_row["dx_equal"]
            and k5_row["mean_err"] <= bn_stats.SUM_RTOL * 10 * scale ** 0.5
            and k5_row["var_err"] <= bn_stats.SUM_RTOL * 10 * scale):
        raise AssertionError(f"phase 25: K5 over bands against its plain version {k5_row}")
    del x, x64, k5_bands
    torch.cuda.empty_cache()

    # (b) one training step of YOLOv3-416, B=16, S=2, against the per-band sums
    row["b_training"], counts = spatial_train_check(bn_stats, resblock, wrappers, reset)
    add(counts)
    inputs = dp_inputs()[0]

    # (c) data 2 × spatial 2: two gloo ranks on the card
    t0 = time.monotonic()
    ranks = run_dp_ranks("gloo-spatial", 2, inputs)
    row["c_data2_spatial2"] = dict(ranks=ranks, seconds=time.monotonic() - t0,
                                   ranks_bit_identical=ranks[0]["digest"] == ranks[1]["digest"])
    log(f"spatial (c) data 2 x spatial 2 {json.dumps(row['c_data2_spatial2'])}")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError(f"phase 25 (c): the ranks' states differ {ranks}")
    for r in ranks:
        if r["counts"]["forward"] != 72 * 2 or r["counts"]["sync_forward"] != 72:
            raise AssertionError(f"phase 25 (c): rank {r['rank']} K5 counts {r['counts']}")
        total["bn_stats"] += r["counts"]["forward"]

    # (d) Serve with spatial_partitioning: 2 on the one card
    cfg = dict(model_config_file=os.path.join(ROOT, "config/models/yolov3_tiny/model.yaml"),
               classes_name_file=os.path.join(ROOT, "datasets/shapes_toy/class.names"),
               anchors_file=os.path.join(ROOT, "datasets/shapes_toy/anchors/anchors_tiny.txt"),
               input_weights_path=os.path.join(ROOT, "checkpoints/output/yolov3_train_tiny.tf"),
               image_size=416, nms_score_threshold=0.1, port=0, batch_buckets=(1, 4),
               serve_forever=False, warmup=False)
    answers = []
    for spatial in (1, 2):
        reset()
        httpd, app = serve_app.Serve()(**cfg, spatial_partitioning=spatial)
        try:
            answers.append(app.detect(bodies[0])["detections"])
        finally:
            app.shutdown()
            httpd.server_close()
        if spatial == 2:
            serve_launches = sp_counts(wrappers, resblock)
    same = (len(answers[0]) == len(answers[1]) > 0 and all(
        a["class_id"] == b["class_id"] and abs(a["score"] - b["score"]) <= 1e-5
        and max(abs(u - v) for u, v in zip(a["box_normalized"], b["box_normalized"])) <= 1e-5
        for a, b in zip(*answers)))
    row["d_serve"] = dict(answers_equal=same, detections=len(answers[0]),
                          launches=serve_launches)
    log(f"spatial (d) serve {json.dumps(row['d_serve'])}")
    if not same or serve_launches["nms_sweep"] == 0:
        raise AssertionError(f"phase 25 (d): serve with spatial_partitioning 2 {row['d_serve']}")
    add(serve_launches)

    # (e) evaluate the trained tiny at 416 with S = 2 against the unsharded run
    sweep = {"evaluate_nms_score_thresholds": [0.004, 0.5]}
    work = os.path.join(SP_DIR, "eval")
    runs = {}
    for spatial in (1, 2):
        reset()
        cfg = tiny_detect_config(tfrecords_dir=os.path.join(TOY_TFRECORDS, "val"),
                                 spatial_partitioning=spatial)
        runs[spatial] = quietly(os.path.join(work, f"s{spatial}"), evaluate_app.evaluate,
                                sweep, cfg)
        if spatial == 2:
            eval_launches = sp_counts(wrappers, resblock)
    same = all(a["counters"] == b["counters"] and a["counters_oneclass"] == b["counters_oneclass"]
               and a["map50"] == b["map50"]
               and np.array_equal(np.asarray(a["ap_per_class"], dtype=float),
                                  np.asarray(b["ap_per_class"], dtype=float), equal_nan=True)
               for a, b in zip(runs[2][0], runs[1][0]))
    row["e_evaluate"] = dict(equal=same, map50=[r["map50"] for r in runs[2][0]],
                             launches=eval_launches, seconds=dict(s1=runs[1][2], s2=runs[2][2]))
    log(f"spatial (e) evaluate {json.dumps(row['e_evaluate'])}")
    if not same or eval_launches["round_sweep"] == 0:
        raise AssertionError(f"phase 25 (e): evaluate with spatial_partitioning 2 "
                             f"{row['e_evaluate']}")
    add(eval_launches)
    return row, total


# --- phase 25b: YOLOv4 at 608² (config/models/yolov4/) ---


def phase_yolov4(smi):
    """Phase 25b (see the module's doc) → its row."""
    from tests import test_torch_yolov4_cuda as cases
    from tests.test_torch_yolov4 import ANCHORS, NC, NMS
    from yolov3_tpu_torch.apps.inference_app import make_predictor
    from yolov3_tpu_torch.models import apply_model, fold_batch_norm
    from yolov3_tpu_torch.models.network import to_device
    from yolov3_tpu_torch.ops.cuda import bias_act
    from yolov3_tpu_torch.ops.cuda.kernel_times import profile_window
    from yolov3_tpu_torch.reference.yolov4_plain import ieee_fp32

    ieee_fp32()  # the reference's float32, as the cases' fixture sets it
    model = cases.seeded_model(cases.SIZE, cases.BATCH, "cuda")
    for dtype in ("fp32", "bf16"):  # each prints its readings, raises on a miss
        cases.test_predictor_against_the_reference_on_the_card(model, dtype)
    spec = model["spec"]
    folded = to_device(fold_batch_norm(model["params"], model["state"]), "cuda", torch.bfloat16)
    images = model["images"].to(torch.bfloat16)

    def forward():
        with torch.inference_mode():
            apply_model(spec, folded, {}, images)

    tails = spec.activation_counts
    _, _, records = profile_window(forward)
    mish = sorted({name for _, name, _ in records if "mish" in name.lower()})
    predict = make_predictor(spec, model["params"], model["state"], ANCHORS, NC,
                             NMS["max_boxes"], NMS["iou_threshold"], NMS["score_threshold"],
                             compute_dtype=torch.bfloat16, image_size=cases.SIZE, device="cuda")
    k8 = {"yolov4-608 bf16": k8_forward(bias_act, f"YOLOv4-608 bf16 B={cases.BATCH}",
                                        lambda: predict(model["images"]), 110)}
    row = dict(card=smi, tails=tails, mish_symbols=mish,
               mish_device_ms=sum(us for _, name, us in records if name in mish) / 1e3,
               forward_device_ms=sum(us for _, _, us in records) / 1e3, k8=k8)
    log(f"phase 25b: {json.dumps(row)}")
    if tails != {"mish": 72, "leaky": 35, "linear": 3} or not mish:
        raise AssertionError(f"phase 25b: tails {tails}, kernels named mish {mish}")
    return row


# --- phase 26: the training-quality recipe (tools/train_convergence.py) ---

CONVERGENCE_DIR = os.path.join(ROOT, "build", "smoke_convergence")
# the recipe's corpus at the phase's size (tools/make_toy_dataset.py through
# train_convergence.ensure_dataset): seed 11, max_overlap 0.15, 416²
CONVERGENCE_CORPUS = dict(n_train=1024, n_val=128, image_size=416, seed=11, max_overlap=0.15)
CONVERGENCE_BATCH = 64
CONVERGENCE_EPOCHS = 120
# sha256 of that corpus as the same generator wrote it on a CPU host with PIL
# 12.1.0: every file (path and digest, sorted by path, one line each), and the
# two TFRecord files that hold every JPEG
CORPUS_PIL = "12.1.0"
CORPUS_SHA256 = dict(
    all_files="0c6603ffda1cf85ca5304cf7a4110bd23909cee7a7466688899b3f56c2f9ce88",
    train="854138775b3e23a360a0f0820f92ab80d09512b6ab018c758494ddbf425b0941",
    val="8e1ea02f1bc65ba0e48b339e93a4f7985d30b9e9453e2885bcbcffddd0be9b54")
MAP_FLOOR = 0.2  # far above the 20-step checkpoint's 0.0135 and any untrained model
INT8_GATE = 0.01  # tools/int8_accuracy_gate.py's bound


def corpus_sha256(root):
    """The digests of ``CORPUS_SHA256`` for the corpus under ``root``."""
    import hashlib

    lines = []
    for path in sorted(glob.glob(f"{root}/**/*", recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            lines.append(f"{os.path.relpath(path, root)} {digest}\n")
    split = {line.split()[0]: line.split()[1] for line in lines}
    return dict(all_files=hashlib.sha256("".join(lines).encode()).hexdigest(),
                train=split["tfrecords/train/file_00.tfrec"],
                val=split["tfrecords/val/file_00.tfrec"])


def phase_convergence(nms_kernel, conv1x1, conv_int8, bn_stats, bodies, smi,
                      epochs=CONVERGENCE_EPOCHS):
    """Phase 26: the port's training-quality recipe
    (``yolov3_tpu_torch.tools.train_convergence``) in this process at full
    width: YOLOv3-tiny at 416², a corpus generated into
    ``build/smoke_convergence/`` (``CONVERGENCE_CORPUS``, its digests held
    against the CPU host's as a finding), B=64, ``mixed_precision``,
    ``device_dataset`` uint8, cosine LR, ``epochs`` epochs; then
    ``evaluate_map50`` of the checkpoint in bf16, ``int8`` and
    ``int8_chain``. K5's launches (each way) are counted over the training
    run, K1's, K3's and K6's over the three evaluations, each set to 0 just
    before. Fails unless the last epoch's train loss is below half the
    first's, bf16 mAP@0.5 >= 0.2, each int8 tier within 0.01 of bf16, no
    served (bf16) w/h logit above log(FLT_MAX), and K1, K3, K5 (both ways)
    and K6 launched. Beside it one step of the same model and batch alone:
    ms, device-busy ms and launches (profiler), as phase 20 measures them."""
    import shutil

    import PIL

    from yolov3_tpu_torch.data.tfrecord import parse_tfrecords
    from yolov3_tpu_torch.tools import train_convergence as tc

    data_root = os.path.join(CONVERGENCE_DIR, "shapes_conv416")
    out_dir = os.path.join(CONVERGENCE_DIR, "yolov3_tiny")
    shutil.rmtree(CONVERGENCE_DIR, ignore_errors=True)
    c = CONVERGENCE_CORPUS
    t0 = time.monotonic()
    tc.ensure_dataset(data_root, c["n_train"], c["n_val"], c["image_size"], c["seed"],
                      c["max_overlap"])
    corpus_s = time.monotonic() - t0
    digests = corpus_sha256(data_root)
    corpus = dict(seconds=corpus_s, pil_here=PIL.__version__, pil_of_the_digests=CORPUS_PIL,
                  identical={k: digests[k] == CORPUS_SHA256[k] for k in digests})
    log(f"convergence corpus {json.dumps(corpus)}")

    bn_stats.bn_sums.launches = bn_stats.bn_moments_dx.launches = 0
    result = tc.main(["--model", "yolov3_tiny", "--image_size", str(c["image_size"]),
                      "--n_train", str(c["n_train"]), "--n_val", str(c["n_val"]),
                      "--seed", str(c["seed"]), "--max_overlap", str(c["max_overlap"]),
                      "--batch_size", str(CONVERGENCE_BATCH), "--epochs", str(epochs),
                      "--data_root", data_root, "--out_dir", out_dir, "--skip_eval"])
    torch.cuda.synchronize()
    k5 = dict(forward=bn_stats.bn_sums.launches, backward=bn_stats.bn_moments_dx.launches)

    model = os.path.join(ROOT, "config/models/yolov3_tiny/model.yaml")
    ckpt = os.path.join(out_dir, "yolov3_tiny.tf")
    nms_kernel.suppression_sweep.launches = 0
    conv1x1.conv1x1_int8_requant.launches = conv_int8.conv_int8.launches = 0
    maps, eval_s = {}, {}
    for tier in (None, "int8", "int8_chain"):
        t0 = time.monotonic()
        r = tc.evaluate_map50(model, ckpt, data_root, c["image_size"], quantize=tier)
        eval_s[tier or "bf16"] = time.monotonic() - t0
        maps[tier or "bf16"] = r["map50"]
        if r["val_images"] != c["n_val"]:
            raise AssertionError(f"convergence: evaluated {r['val_images']} images")
    launches = dict(nms_sweep=nms_kernel.suppression_sweep.launches,
                    conv1x1_int8=conv1x1.conv1x1_int8_requant.launches,
                    conv_int8=conv_int8.conv_int8.launches, bn_stats=k5)

    files = dict(model=model, names=os.path.join(data_root, "class.names"),
                 anchors=os.path.join(data_root, "anchors", "anchors_tiny.txt"))
    val_images = torch.from_numpy(np.stack([im for im, _ in itertools.islice(parse_tfrecords(
        os.path.join(data_root, "tfrecords", "val"), c["image_size"], 100, files["names"]),
        16)]).astype(np.float32))
    overflow = served_head_overflow(files, ckpt, val_images, torch.bfloat16)
    step = step_profile("yolov3_tiny B=64 bf16", {"compute_dtype": torch.bfloat16}, bodies, 3,
                        files, batch=CONVERGENCE_BATCH)

    train, val = result["train_loss"], result["val_loss"]
    steps = epochs * (c["n_train"] // CONVERGENCE_BATCH)
    row = dict(model="yolov3_tiny", image_size=c["image_size"], batch=CONVERGENCE_BATCH,
               corpus=dict(corpus, n_train=c["n_train"], n_val=c["n_val"]), epochs=epochs,
               steps=steps, wall_seconds=result["wall_seconds"],
               trained_img_per_s=epochs * c["n_train"] / result["wall_seconds"],
               last_epoch_img_per_s=result["img_per_sec"][epochs],
               host_peak_rss_gb=result["host_peak_rss_gb"],
               train_loss=dict(first=train[1], last=train[epochs]),
               val_loss=dict(first=val[1], last=val[epochs]),
               map50=maps, eval_seconds=eval_s, launches=launches,
               served_wh_logit_max=overflow["largest_wh_logit"],
               served_overflow=overflow["heads"], step=step, card=smi)
    log(f"convergence {json.dumps(row)}")
    failures = []
    if not train[epochs] < 0.5 * train[1]:
        failures.append(f"last train loss {train[epochs]} not below half the first {train[1]}")
    if not maps["bf16"] >= MAP_FLOOR:
        failures.append(f"bf16 mAP@0.5 {maps['bf16']} below {MAP_FLOOR}")
    for tier in ("int8", "int8_chain"):
        if abs(maps[tier] - maps["bf16"]) > INT8_GATE:
            failures.append(f"{tier} mAP@0.5 {maps[tier]} not within {INT8_GATE} of bf16 "
                            f"{maps['bf16']}")
    if overflow["largest_wh_logit"] > EXP_F32_LIMIT:
        failures.append(f"served w/h logit {overflow['largest_wh_logit']} above {EXP_F32_LIMIT}")
    if min(launches["nms_sweep"], launches["conv1x1_int8"], launches["conv_int8"],
           k5["forward"], k5["backward"]) == 0:
        failures.append(f"a kernel did not launch: {launches}")
    if failures:
        raise AssertionError("convergence: " + "; ".join(failures))
    return row, launches



# --- phase 27: the custom-dataset transfer recipe (tools/pets_transfer.py) ---

TRANSFER_DIR = os.path.join(ROOT, "build", "smoke_transfer")
PETS_TRAIN = os.path.join(ROOT, "datasets", "pets_mini", "train")
TRANSFER_BATCH = 8
TRANSFER_EPOCHS = 40  # --freeze config
TRANSFER_PATIENCE = 4
TRANSFER_NONE_EPOCHS = 3  # --freeze none


def bn_layers(spec, frozen=()):
    """BatchNorm layers of ``spec`` outside the sub-models whose names
    contain a selector of ``frozen`` (``batch_norm_freeze_list``)."""
    return sum(1 for sm in spec.sub_models if not any(s in sm.name for s in frozen)
               for layer in sm.layers
               if layer.kind == "convolutional" and layer["batch_normalize"])


def checkpoint_leaves(ckpt):
    from yolov3_tpu_torch.io.checkpoint import _flatten, load_checkpoint

    return _flatten(load_checkpoint(ckpt + ".npz")[0])


def darknet_backbone():
    """Phase 21's converted YOLOv3-416 (80 classes) checkpoint; where phase 21
    left none, the same synthetic ``yolov3.weights`` converted here."""
    ckpt = os.path.join(CONVERT_DIR, "yolov3_converted.tf")
    if os.path.exists(ckpt + ".npz"):
        return ckpt, "phase 21"
    from yolov3_tpu_torch.config import read_class_names
    from yolov3_tpu_torch.io.darknet import load_darknet_weights, save_darknet_weights
    from yolov3_tpu_torch.io.resolve import save_weights
    from yolov3_tpu_torch.models import init_model, parse_model_config
    from yolov3_tpu_torch.tree import tree_map

    spec = parse_model_config(os.path.join(ROOT, "config/models/yolov3/model.yaml"),
                              len(read_class_names(os.path.join(ROOT,
                                                                "datasets/coco2012/coco.names"))))
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    weights = os.path.join(TRANSFER_DIR, "yolov3.weights")
    save_darknet_weights(spec, params, tree_map(lambda v: v + 0.25, state), weights)
    params, state = load_darknet_weights(spec, weights)
    ckpt = os.path.join(TRANSFER_DIR, "yolov3_converted.tf")
    save_weights(spec, params, state, ckpt)
    return ckpt, "converted in phase 27"


def checkpoint_val_loss(cfg, ckpt):
    """The trainer's validation loss of ``ckpt`` on the card: its val split
    staged as ``cfg`` stages it, its eval step (fp32, BN frozen as ``cfg``
    freezes it), the mean over the batches."""
    from yolov3_tpu_torch.config import get_anchors, read_class_names
    from yolov3_tpu_torch.data.pipeline import DeviceDataset, create_dataset
    from yolov3_tpu_torch.io.resolve import load_weights
    from yolov3_tpu_torch.models import init_model, parse_model_config
    from yolov3_tpu_torch.models.network import head_grid_sizes, to_device
    from yolov3_tpu_torch.models.transfer import bn_frozen_selectors
    from yolov3_tpu_torch.parallel.train_step import make_eval_step

    spec = parse_model_config(cfg["model_config_file"],
                              len(read_class_names(cfg["classes_name_file"])))
    params, state = load_weights(spec, *init_model(spec, torch.Generator().manual_seed(0)), ckpt)
    (_, ds_val), _ = create_dataset(cfg["dataset_config"], cfg["image_size"], cfg["max_bboxes"],
                                    cfg["classes_name_file"], cfg["max_dataset_examples"])
    val = DeviceDataset(ds_val, cfg["batch_size"], "cuda", store_uint8=True)
    step = make_eval_step(spec, get_anchors(cfg["anchors_file"]),
                          head_grid_sizes(spec, cfg["image_size"]), cfg["batch_size"],
                          bn_frozen=bn_frozen_selectors(
                              cfg["transfer_learning_config"]["batch_norm_freeze_list"]))
    params, state = to_device(params, "cuda"), to_device(state, "cuda")
    return float(np.mean([float(step(params, state, im, lb)["total_loss"])
                          for im, lb in val.batches(None)]))


def transfer_run(pets_transfer, wrappers, bn_stats, out_dir, *args):
    """One ``pets_transfer.main`` in this process, every count set to 0 just
    before it and read just after → (result, seconds, launches, the
    trainer's per-epoch (steps, seconds))."""
    import re

    for w in wrappers.values():
        w.launches = 0
    bn_stats.bn_sums.launches = bn_stats.bn_moments_dx.launches = 0
    lines = _LogLines()
    trainer_log = logging.getLogger("yolov3_tpu_torch.apps.train_app")
    trainer_log.addHandler(lines)
    t0 = time.monotonic()
    try:
        result = pets_transfer.main(["--batch_size", str(TRANSFER_BATCH), "--out_dir", out_dir,
                                     "--eval_max_images", "16", *args])
        torch.cuda.synchronize()
    finally:
        trainer_log.removeHandler(lines)
    seconds = time.monotonic() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    launches["bn_stats"] = dict(forward=bn_stats.bn_sums.launches,
                                backward=bn_stats.bn_moments_dx.launches)
    epochs = [(int(m.group(2)), float(m.group(3))) for m in
              (re.search(r"epoch (\d+): (\d+) steps in ([\d.]+)s", ln)
               for ln in lines.lines) if m]
    return result, seconds, launches, epochs, lines.lines


def phase_transfer(nms_kernel, conv1x1, conv_int8, bn_stats, smi):
    """Phase 27: the custom-dataset transfer recipe
    (``yolov3_tpu_torch.tools.pets_transfer``) in this process, outputs under
    ``build/smoke_transfer/``: YOLOv3 at 416² from phase 21's converted
    80-class checkpoint onto the 38 classes of the bundled ``pets_mini`` (48 +
    16 photos of mixed sizes, COCO JSON), B=8, bf16, the splits staged as
    uint8, mosaic + HSV, cosine LR. ``--freeze config`` for ``TRANSFER_EPOCHS``
    epochs with early-stopping patience ``TRANSFER_PATIENCE``, then
    ``--freeze none`` for ``TRANSFER_NONE_EPOCHS``; each ends in the int8
    gate over the val split. Every count is set to 0 just before each run.
    Fails unless: the backbone's params and the backbone's and neck's BN
    statistics are byte-identical to the source and the neck's params moved
    (config); K5's forward launches are the BN layers outside the frozen
    sub-models × steps (config) and all BN layers × steps (none); every loss
    is finite and the last train loss is below the first; the run stopped
    early and its checkpoint's val loss, recomputed on the card, is the best
    epoch's; the gate's result carries ``gate_pass``; K1, K3 and K6 launched."""
    import shutil

    from yolov3_tpu_torch.config import read_class_names
    from yolov3_tpu_torch.models import parse_model_config
    from yolov3_tpu_torch.ops.cuda import bias_act
    from yolov3_tpu_torch.tools import pets_transfer

    shutil.rmtree(TRANSFER_DIR, ignore_errors=True)
    os.makedirs(TRANSFER_DIR)
    backbone, source = darknet_backbone()
    spec = parse_model_config(os.path.join(ROOT, "config/models/yolov3/model.yaml"),
                              len(read_class_names(os.path.join(ROOT,
                                                                "datasets/pets_breed.names"))))
    wrappers = dict(nms_sweep=nms_kernel.suppression_sweep,
                    conv1x1_int8=conv1x1.conv1x1_int8_requant, conv_int8=conv_int8.conv_int8,
                    bias_act=bias_act.bias_act)
    frozen = ("backbone", "neck")  # train_config_pets.yaml's batch_norm_freeze_list
    runs, failures = {}, []
    for mode, epochs, extra in (("config", TRANSFER_EPOCHS, ["--patience",
                                                             str(TRANSFER_PATIENCE)]),
                                ("none", TRANSFER_NONE_EPOCHS, ["--freeze", "none"])):
        out_dir = os.path.join(TRANSFER_DIR, mode)
        result, seconds, launches, per_epoch, lines = transfer_run(
            pets_transfer, wrappers, bn_stats, out_dir, "--backbone_ckpt", backbone,
            "--epochs", str(epochs), *extra)
        train, val = result["train_loss"], result["val_loss"]
        steps = sum(n for n, _ in per_epoch)
        expected_k5 = bn_layers(spec, frozen if mode == "config" else ()) * steps
        gate = result["int8_gate"]
        run = dict(seconds=seconds, epochs=len(train), steps=steps,
                   trained_img_per_s=steps * TRANSFER_BATCH / sum(s for _, s in per_epoch),
                   train_loss=dict(first=train[1], last=train[max(train)]),
                   val_loss=dict(first=val[1], last=val[max(val)], best=min(val.values()),
                                 best_epoch=min(val, key=val.get)),
                   launches=launches, k5_forward_expected=expected_k5,
                   gate={k: gate.get(k) for k in ("images", "map50_bf16", "map50_int8",
                                                  "map50_delta", "gate_pass")})
        ckpt = os.path.join(out_dir, "yolov3_pets.tf")
        if launches["bn_stats"]["forward"] != expected_k5:
            failures.append(f"{mode}: K5 forward {launches['bn_stats']['forward']} launches, "
                            f"expected {expected_k5}")
        if not all(np.isfinite(v) for series in (train, val) for v in series.values()):
            failures.append(f"{mode}: a loss is not finite")
        if not train[max(train)] < train[1]:
            failures.append(f"{mode}: last train loss {train[max(train)]} not below the first")
        if "gate_pass" not in gate or min(launches[k] for k in wrappers) == 0:
            failures.append(f"{mode}: gate {gate} with launches {launches}")
        if mode == "config":
            src, got = checkpoint_leaves(backbone), checkpoint_leaves(ckpt)
            kept = [k for k in got if k.split("/")[1] == "backbone"
                    or (k.startswith("bn_state/") and k.split("/")[1].startswith("neck"))]
            neck = [k for k in got
                    if k.startswith("params/") and k.split("/")[1].startswith("neck")]
            run.update(frozen_leaves=len(kept),
                       frozen_byte_identical=all(got[k].tobytes() == src[k].tobytes()
                                                 for k in kept),
                       neck_params_moved=sum(got[k].tobytes() != src[k].tobytes() for k in neck),
                       neck_params=len(neck),
                       stopped_early=any(ln.startswith("early stopping at epoch")
                                         for ln in lines))
            cwd = os.getcwd()
            os.chdir(ROOT)  # the config's paths are the repo's
            try:
                run["checkpoint_val_loss"] = checkpoint_val_loss(result["config"], ckpt)
            finally:
                os.chdir(cwd)
            best = run["val_loss"]["best"]
            if not (run["frozen_byte_identical"] and len(kept) > 100
                    and run["neck_params_moved"] > 0):
                failures.append(f"config: frozen leaves {run}")
            if not (run["stopped_early"]
                    and abs(run["checkpoint_val_loss"] - best) <= 1e-4 * abs(best) + 5e-5):
                failures.append(f"config: stopped early {run['stopped_early']}, checkpoint val "
                                f"loss {run['checkpoint_val_loss']} against the best {best}")
        runs[mode] = run
        log(f"transfer --freeze {mode} {json.dumps(run)}")
    row = dict(model="yolov3", image_size=416, batch=TRANSFER_BATCH, backbone=source,
               bn_layers=dict(all=bn_layers(spec), unfrozen=bn_layers(spec, frozen)),
               runs=runs, card=smi)
    if failures:
        raise AssertionError("transfer: " + "; ".join(failures))
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in wrappers}
    launches["bn_stats"] = {d: sum(r["launches"]["bn_stats"][d] for r in runs.values())
                            for d in ("forward", "backward")}
    return row, launches


# --- phase 28: the custom-dataset host and eval tools ---

TOOLS_DIR = os.path.join(ROOT, "build", "smoke_tools")
PETS_SHARD = 16  # examples a shard: 48 training photos, three shards
PETS_ANCHORS = 9
# sha256 of create_tfrecords' output for pets_mini's train split (shards of 16,
# with --names_out) and of the anchors file create_yolov3_anchors clusters from
# it (numpy's k-means: sklearn blocked), as written on a CPU host (numpy 2.0.2)
TOOLS_NUMPY = "2.0.2"
TOOLS_SHA256 = {
    "pets_train/class.names": "511b1b6f26e677cf63ec11239a7273e3d517a265608bbccad8de10ee0723fedc",
    "pets_train/file_00.tfrec": "a26c5842c2c8c9fc5f36101500ee1fe38f68fe618ce8a29631a7ed832c148a88",
    "pets_train/file_01.tfrec": "35467d413f95f128e5c6d1e9c9eb297a6c31e9cf8dff76725eacac207f50d489",
    "pets_train/file_02.tfrec": "78de7426bf6fba9fc0fdd77b74abcb650b010f87bfdf84cb92cf069fd25796dc",
    "anchors/pets_anchors.txt": "e4cff296b7f50f2d1ddd077a7030236ec8e0ce98788fd8e5987a0f192f29ecb8",
}
SCALE_CORPUS = dict(n_train=8, n_val=32, seed=11, max_overlap=0.15)


def sha256_of(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def dataset_tool_files(out_dir):
    """``create_tfrecords`` of pets_mini's train split into ``out_dir``, then
    ``create_yolov3_anchors`` over those records, run from ``out_dir`` on a
    config whose paths are relative to it → {file: sha256}, the anchors."""
    import yaml

    from yolov3_tpu_torch.tools import create_tfrecords, create_yolov3_anchors

    records = os.path.join(out_dir, "pets_train")
    create_tfrecords.main(["--images_dir", PETS_TRAIN,
                           "--annotations", os.path.join(PETS_TRAIN, "_annotations.coco.json"),
                           "--out_dir", records, "--shard_size", str(PETS_SHARD),
                           "--names_out", os.path.join(records, "class.names")])
    with open(os.path.join(out_dir, "anchors_config.yaml"), "w") as f:
        yaml.safe_dump({"n_clusters": PETS_ANCHORS, "input_data_source": "tfrecords",
                        "tfrecords": {"tfrecords_dir": "pets_train"}, "limit": "None",
                        "anchors_out_file": "anchors/pets_anchors.txt"}, f)
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        anchors = create_yolov3_anchors.main(["--config", "anchors_config.yaml"])
    finally:
        os.chdir(cwd)
    files = sorted(glob.glob(os.path.join(records, "*"))) + [
        os.path.join(out_dir, "anchors", "pets_anchors.txt")]
    return {os.path.relpath(p, out_dir): sha256_of(p) for p in files}, anchors


def phase_dataset_tools(nms_kernel, smi):
    """Phase 28: the custom-dataset tools, outputs under ``build/smoke_tools/``:
    (a) ``create_tfrecords`` of pets_mini's train split and
    ``create_yolov3_anchors`` over its records (numpy's k-means where sklearn
    is absent, as on the card's host), their sha256 against a CPU host's
    (``TOOLS_SHA256``, a finding); (b) ``visualize_assignment`` of
    ``train_config_pets.yaml`` (YOLOv3's three heads at 416) on the card and
    with ``--device cpu`` (its ``assignment`` alone where the host has no
    matplotlib to render with): the cubes bit-equal; (c) ``scale_matrix`` with its
    variants pointed at phase 15's fp32 YOLOv3-416 checkpoint and phase 22's
    recalibration of it, its 416 and 608 corpora generated by
    ``make_toy_dataset`` (``SCALE_CORPUS``), K1 counted over it: every cell
    filled; (d) one full-width YOLOv3 predict at 608², B=16, bf16, timed.
    Fails unless the shards and the ``.names`` file are the CPU host's bytes
    (the anchors' digest is a finding: numpy's float order may differ), (b)
    is bit-equal, every (c) cell holds a number and K1 launched."""
    import importlib.util
    import shutil

    import yaml

    from yolov3_tpu_torch.config import load_yaml
    from yolov3_tpu_torch.tools import scale_matrix, train_convergence, visualize_assignment

    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    t0 = time.monotonic()
    digests, anchors = dataset_tool_files(TOOLS_DIR)
    files = dict(seconds=time.monotonic() - t0, numpy_here=np.__version__,
                 numpy_of_the_digests=TOOLS_NUMPY,
                 kmeans="sklearn" if importlib.util.find_spec("sklearn") else "numpy",
                 identical={k: v == TOOLS_SHA256.get(k) for k, v in digests.items()},
                 anchors=anchors.tolist())

    config = os.path.join(TOOLS_DIR, "pets_assign.yaml")
    pets = load_yaml(os.path.join(ROOT, "config/train_config_pets.yaml"))
    with open(config, "w") as f:
        yaml.safe_dump(pets, f)
    # the tool renders through matplotlib, which a host may lack: there its
    # assignment alone runs, on each device
    rendered = importlib.util.find_spec("matplotlib") is not None
    cubes, assign_s = {}, {}
    cwd = os.getcwd()
    os.chdir(ROOT)  # the config's paths are the repo's
    try:
        for dev in ("cuda", "cpu"):
            t0 = time.monotonic()
            if rendered:
                cubes[dev] = visualize_assignment.main(
                    ["--config", config, "--out", os.path.join(TOOLS_DIR, f"assign_{dev}.png")]
                    + (["--device", "cpu"] if dev == "cpu" else []))
            else:
                cubes[dev] = visualize_assignment.assignment(pets, torch.device(dev))[1]
            assign_s[dev] = time.monotonic() - t0
    finally:
        os.chdir(cwd)
    assignment = dict(seconds=assign_s, rendered=rendered,
                      grids=[c.shape[0] for c in cubes["cuda"]],
                      assigned=[int((c[..., 4] == 1).sum()) for c in cubes["cuda"]],
                      bit_equal=all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
                                    for a, b in zip(cubes["cuda"], cubes["cpu"])))

    corpora = {}
    for size in (416, 608):
        corpora[size] = os.path.join(TOOLS_DIR, f"shapes_conv{size}")
        c = SCALE_CORPUS
        train_convergence.ensure_dataset(corpora[size], c["n_train"], c["n_val"], size,
                                         c["seed"], c["max_overlap"])
    variants = {"phase15_fp32": os.path.join(ROOT, "build", "smoke_train", "fp32",
                                             "yolov3_toy.tf"),
                "phase15_fp32_recal416": os.path.join(CONVERT_DIR, "yolov3_toy_recal_cuda.tf")}
    evals = {"320": (corpora[608], 320), "416": (corpora[416], 416), "608": (corpora[608], 608)}
    nms_kernel.suppression_sweep.launches = 0
    t0 = time.monotonic()
    out = scale_matrix.main(["--out", os.path.join(TOOLS_DIR, "scale_matrix.json")],
                            variants=variants, evals=evals)
    torch.cuda.synchronize()
    matrix = dict(seconds=time.monotonic() - t0, rows=out["rows"],
                  k1_launches=nms_kernel.suppression_sweep.launches)
    cells = [row.get(f"map50_at_{col}") for row in out["rows"].values() for col in evals]
    predict_608 = time_predict_608(variants["phase15_fp32"], corpora[608])

    row = dict(files=files, assignment=assignment, scale_matrix=matrix, predict_608=predict_608,
               card=smi)
    log(f"dataset tools {json.dumps(row)}")
    records = [k for k in digests if k.startswith("pets_train/")]
    if not (all(files["identical"][k] for k in records) and len(records) == 4
            and assignment["bit_equal"] and sum(assignment["assigned"]) > 0
            and len(cells) == 6 and all(isinstance(v, float) and np.isfinite(v) for v in cells)
            and matrix["k1_launches"] > 0):
        raise AssertionError(f"dataset tools failed their checks: {row}")
    return row, {"nms_sweep": matrix["k1_launches"]}


def time_predict_608(ckpt, corpus, batch=16):
    """YOLOv3 (3 classes, ``ckpt``) served in bf16 at 608², B=16, on the
    corpus's first val images: device ms a call (CUDA events) and host ms a
    call ending in a synchronize."""
    from yolov3_tpu_torch.apps.inference_app import make_predictor
    from yolov3_tpu_torch.config import get_anchors
    from yolov3_tpu_torch.data.tfrecord import parse_tfrecords
    from yolov3_tpu_torch.io.resolve import load_weights
    from yolov3_tpu_torch.models import init_model, parse_model_config

    spec = parse_model_config(os.path.join(ROOT, "config/models/yolov3/model.yaml"), 3)
    params, state = load_weights(spec, *init_model(spec, torch.Generator().manual_seed(0)), ckpt)
    predict = make_predictor(spec, params, state,
                             get_anchors(os.path.join(corpus, "anchors", "anchors.txt")), 3, 100,
                             0.5, 0.01, device="cuda", compute_dtype=torch.bfloat16)
    images = np.stack([im for im, _ in itertools.islice(parse_tfrecords(
        os.path.join(corpus, "tfrecords", "val"), 608, 100,
        os.path.join(corpus, "class.names")), batch)]).astype(np.float32)
    ms = cuda_ms(lambda: predict(images), 5)
    t0 = time.perf_counter()
    for _ in range(5):
        predict(images)
    torch.cuda.synchronize()
    return dict(batch=batch, image_size=608, compute_dtype="bfloat16", device_event_ms=ms,
                host_ms=(time.perf_counter() - t0) * 1e3 / 5)



# --- phase 29: the measurement tools (yolov3_tpu_torch/tools/) ---

MEASURE_DIR = os.path.join(ROOT, "build", "smoke_measure")
# the kernels each tool must launch in its run (the counts set to 0 just before)
K1, K2, K3, K4, K5, K6, K7 = ("nms_sweep", "round_sweep", "conv1x1_int8", "resblock_int8",
                              "bn_stats", "conv_int8", "bn_leaky")


def kernel_counts():
    """Every wrapper's launch count: K1–K4, K6, K5 (forward, backward, and
    the synced launches each way) and K7 (forward, backward)."""
    from yolov3_tpu_torch.ops.cuda import (bn_leaky, conv1x1, conv_int8, nms_kernel, resblock,
                                           round_sweep)

    return dict({K1: nms_kernel.suppression_sweep.launches, K2: round_sweep.round_sweep.launches,
                 K3: conv1x1.conv1x1_int8_requant.launches, K4: resblock.fused_resblock.launches,
                 K6: conv_int8.conv_int8.launches},
                **{f"{K5}_{k}": v for k, v in k5_counts().items()},
                **{f"{K7}_forward": bn_leaky.bn_leaky.launches,
                   f"{K7}_backward": bn_leaky.bn_leaky_dx.launches})


def reset_kernel_counts():
    from yolov3_tpu_torch.ops.cuda import (bn_leaky, conv1x1, conv_int8, nms_kernel, resblock,
                                           round_sweep)

    nms_kernel.suppression_sweep.launches = round_sweep.round_sweep.launches = 0
    conv1x1.conv1x1_int8_requant.launches = resblock.fused_resblock.launches = 0
    conv_int8.conv_int8.launches = 0
    bn_leaky.bn_leaky.launches = bn_leaky.bn_leaky_dx.launches = 0
    reset_k5_counts()


def multihost_rank(*argv):
    """A rank of phase 29's ``multihost_smoke`` (``--multihost-smoke``): the
    tool's ``main`` in this process, then its K5 counts as the last line."""
    from yolov3_tpu_torch.tools import multihost_smoke

    reset_kernel_counts()
    result = multihost_smoke.main(list(argv))
    torch.cuda.synchronize()
    print(json.dumps(dict(result, launches=kernel_counts())), flush=True)
    return 0


def multihost_ranks(world=2):
    """``multihost_smoke`` as ``world`` gloo ranks sharing the card, each a
    process of its own → their rows (the MULTIHOST_OK line, the counts)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multihost-smoke",
                               "--coordinator", f"127.0.0.1:{port}", "--num_processes",
                               str(world), "--process_id", str(rank), "--backend", "gloo"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rows = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"multihost_smoke rank {rank} failed (rc {p.returncode}): "
                                 f"{err[-3000:]}")
        lines = out.strip().splitlines()
        rows.append(dict(json.loads(lines[-1]),
                         line=next(ln for ln in lines if ln.startswith("MULTIHOST_OK"))))
    return rows


def phase_measurement_tools(convergence_row, smi, decode_tier):
    """Phase 29: every measurement tool of ``yolov3_tpu_torch/tools/`` through
    its ``main(argv)`` on the card at full width (YOLOv3-416, 80 classes,
    seeded weights), each tool's printing under ``build/smoke_measure/``:
    ``bench`` in ``int8``, ``int8_chain`` and ``bf16`` (B=128, 8 batches a
    pass); ``latency_bench`` in ``int8`` (the chain tier) and bf16 (50
    chained predicts, 5 reps); ``profile_inference`` (B=128, 4 batches);
    ``mfu_table`` in ``int8_chain`` and ``bf16`` (B=128); ``profile_eval``
    (B=32, 608², 2 batches, K=512 and K=N); ``profile_train --trace`` at B=16
    in bf16 and fp32; ``bench_resblock`` at 13², 26², 52² (B=128);
    ``bench_input_pipeline`` on phase 26's corpus at B=64 (1 and 8 workers,
    192 images) against phase 26's trained img/s; ``multihost_smoke`` as two
    gloo ranks sharing the card.
    Every count is set to 0 just before each tool and read just after.
    Fails unless each tool launches every kernel its row names, every
    ``mfu_table`` share is at most 100%, ``bench_input_pipeline`` decodes on
    ``decode_tier`` (the native build's outcome), and the two ranks print one loss
    (each tool raises on a non-finite checksum or loss itself) → (the
    phase's row, the launches summed over its tools)."""
    import contextlib
    import io
    import shutil

    from yolov3_tpu_torch.tools import (bench, bench_input_pipeline, bench_resblock,
                                        latency_bench, mfu_table, profile_eval,
                                        profile_inference, profile_train)

    shutil.rmtree(MEASURE_DIR, ignore_errors=True)
    os.makedirs(MEASURE_DIR)
    corpus = os.path.join(CONVERGENCE_DIR, "shapes_conv416")
    target = convergence_row["trained_img_per_s"]
    runs = [
        ("bench int8", (K1, K3, K6), lambda: bench.main(
            [], env=dict(BENCH_QUANTIZE="int8", BENCH_ITERS="8"))),
        ("bench int8_chain", (K1, K3, K4, K6), lambda: bench.main(
            [], env=dict(BENCH_QUANTIZE="int8_chain", BENCH_ITERS="8"))),
        ("bench bf16", (K1,), lambda: bench.main(
            [], env=dict(BENCH_QUANTIZE="bf16", BENCH_ITERS="8"))),
        ("latency_bench int8", (K1, K3, K4, K6), lambda: latency_bench.main(
            ["--quantize", "int8", "--iters", "50", "--reps", "5"])),
        ("latency_bench bf16", (K1,), lambda: latency_bench.main(
            ["--iters", "50", "--reps", "5"])),
        ("profile_inference", (K1,), lambda: profile_inference.main(["--iters", "4"])),
        ("mfu_table int8_chain", (K3, K4, K6), lambda: mfu_table.main(
            ["--quantize", "int8_chain", "--csv",
             os.path.join(MEASURE_DIR, "mfu_int8_chain.csv")])),
        ("mfu_table bf16", (), lambda: mfu_table.main(
            ["--quantize", "bf16", "--csv", os.path.join(MEASURE_DIR, "mfu_bf16.csv")])),
        ("profile_eval", (K1, K2), lambda: profile_eval.main(["--iters", "2"])),
        ("profile_train bf16", (f"{K5}_forward", f"{K5}_backward", f"{K7}_forward",
                                f"{K7}_backward"), lambda: profile_train.main(
            ["--batch", "16", "--steps", "2", "--trace", "--top", "8", "--top_fusions", "4"])),
        ("profile_train fp32", (f"{K5}_forward", f"{K5}_backward", f"{K7}_forward",
                                f"{K7}_backward"), lambda: profile_train.main(
            ["--batch", "16", "--steps", "2", "--trace", "--fp32", "--top", "8"])),
        ("bench_resblock", (K3, K4, K6), lambda: bench_resblock.main(
            ["--stages", "13,26,52"])),
        ("bench_input_pipeline", (), lambda: bench_input_pipeline.main(
            ["--data_root", corpus, "--batch", "64", "--workers", "1", "8",
             "--max_images", "192", "--target", str(target)])),
    ]
    rows, totals, failures = {}, dict.fromkeys(kernel_counts(), 0), []
    for name, expect, run in runs:
        torch.cuda.empty_cache()
        reset_kernel_counts()
        printed = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(printed):
            result = run()
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        counts = kernel_counts()
        for k, v in counts.items():
            totals[k] += v
        with open(os.path.join(MEASURE_DIR, name.replace(" ", "_") + ".txt"), "w") as f:
            f.write(printed.getvalue())
        missing = [k for k in expect if counts[k] == 0]
        if missing:
            failures.append(f"{name} launched none of {missing}")
        if name == "bench_input_pipeline" and result["decode"] != decode_tier:
            failures.append(f"{name} decoded on {result['decode']}, the build gave "
                            f"{decode_tier}")
        if name.startswith("mfu_table"):
            top = max([r["mfu_pct"] for r in result["rows"]]
                      + [result["e2e_mfu_pct"], result["attributed_mfu_pct"]])
            if top > 100.0:
                failures.append(f"{name}: an MFU share above 100% ({top})")
            result = dict(result, rows=result["rows"][:8])  # the slowest layers
        rows[name] = dict(seconds=seconds, launches={k: v for k, v in counts.items() if v},
                          result=result)
        log(f"measurement tool {name}: {seconds:.1f} s {json.dumps(rows[name]['launches'])}")

    t0 = time.monotonic()
    ranks = multihost_ranks()
    losses = {r["loss"] for r in ranks}
    rows["multihost_smoke"] = dict(seconds=time.monotonic() - t0,
                                   lines=[r["line"] for r in ranks],
                                   launches=[{k: v for k, v in r["launches"].items() if v}
                                             for r in ranks])
    log(f"measurement tool multihost_smoke: {json.dumps(rows['multihost_smoke'])}")
    for r in ranks:
        for k, v in r["launches"].items():
            totals[k] += v
    if len(losses) != 1:
        failures.append(f"multihost_smoke: the ranks' losses differ: {losses}")
    if not all(r["launches"][f"{K5}_forward"] and r["launches"][f"{K5}_sync_forward"]
               and r["launches"][f"{K5}_backward"] for r in ranks):
        failures.append("multihost_smoke: a rank ran no synced K5")
    row = dict(tools=rows, card=smi, launches=totals)
    log(f"measurement tools {json.dumps(row)}")
    if failures:
        raise AssertionError("measurement tools: " + "; ".join(failures))
    return row, totals


# --- phase 30: the browser port's path (export, executor, jsvm) ---

BROWSER_DIR = os.path.join(ROOT, "build", "smoke_browser")
BROWSER_TOL = 1e-3  # executor heads against the eager fp32 forward, of a head's largest |value|


def export_files(out_dir):
    """An exported graph-model directory → (MB, digests): the sha256 of
    model.json and of its shards, read in manifest order as one stream."""
    import hashlib

    with open(os.path.join(out_dir, "model.json")) as f:
        paths = json.load(f)["weightsManifest"][0]["paths"]
    shards = hashlib.sha256()
    for p in paths:
        with open(os.path.join(out_dir, p), "rb") as f:
            shards.update(f.read())
    names = os.listdir(out_dir)
    return (sum(os.path.getsize(os.path.join(out_dir, n)) for n in names) / 1e6,
            {"model.json": sha256_of(os.path.join(out_dir, "model.json")),
             f"{len(paths)} shards": shards.hexdigest()})


def timed_export(export_tfjs, model_file, ckpt, names, prebuilt, out_dir, quantize):
    """One ``export_tfjs`` run into ``out_dir`` → (seconds, MB, digests)."""
    import contextlib
    import io
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()):
        export_tfjs.export_tfjs_graph_model(model_file, ckpt, names, 416, out_dir,
                                            prebuilt=prebuilt, quantize=quantize)
    seconds = time.monotonic() - t0
    return (seconds, *export_files(out_dir))


def js_decoded(heads, anchors, nclasses):
    """The browser port's own decode (js/src/decode.js through jsvm) of the
    executor's heads → (boxes, scores) on the CPU, as nms.js scores them."""
    from yolov3_tpu_torch.jsvm import Interpreter, TfShim

    shim = TfShim()
    interp = Interpreter({"tf": shim})
    mod = interp.load_module(os.path.join(ROOT, "js", "src", "decode.js"))
    out = interp.call(mod["decodeOutputs"], [shim.tensor(h.cpu().numpy()) for h in heads],
                      np.asarray(anchors, np.float32).reshape(-1, 3, 2).tolist(),
                      float(nclasses))
    boxes = torch.from_numpy(out["boxes"]._np()[0])
    scores = torch.from_numpy(out["confidence"]._np()[0, :, 0]
                              * out["classProbs"]._np()[0].max(-1))
    return boxes, scores


def run_js(run_js_pipeline, *argv):
    """``run_js_pipeline.main`` on the card with ``--compare`` → (its result,
    its wall seconds, its printing)."""
    import contextlib
    import io

    printed = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(printed):
        result = run_js_pipeline.main(list(argv) + ["--compare"])
    torch.cuda.synchronize()
    return result, time.monotonic() - t0, printed.getvalue()


def phase_browser(nms_mod, nms_kernel, round_sweep, smi):
    """Phase 30: the browser port's path on the card, with no TensorFlow
    (outputs under ``build/smoke_browser/``).

    (a) ``tools/export_tfjs.py`` exports phase 21's converted YOLOv3-416 (80
    classes; converted here where phase 21 left none) in float32 and uint8,
    each twice from one fold: seconds, MB, the sha256 of model.json and of
    every shard; the second export must equal the first byte for byte.
    (b) ``export/tfjs_runtime.GraphModel`` runs the float32 export on the
    card: each head within ``BROWSER_TOL`` of the eager fp32 forward of the
    same checkpoint on the card (of the head's largest |value|), B=1 ms of
    both by CUDA events; the uint8 export's heads against the same forward
    (printed). (c) ``tools/run_js_pipeline.py --compare`` drives
    js/src/inference.js through the port's jsvm, ``GraphModelHost`` on the
    card: the trained YOLOv3-tiny (``checkpoints/output``, shapes_toy's
    classes) on the first shapes_toy val image, counts and classes equal to
    the compare leg's and boxes and scores within ``NEAR_TIE``, or a near-tie
    witness (``near_tie_witness``, the JS side's own decode against the
    compare leg's); then the float32 YOLOv3-416 export on the bundled
    ``girl.png``: the structural contract of tests/test_js_execution.py (the
    count equals the Python pipeline's, detections well-formed, no tensor
    left live), and ``yolo_nms`` at K = N on the compare leg's decoded boxes
    equal to its ``yolo_nms_exact``. K1 and K2 are set to 0 just before (c)
    and read just after: each must have launched → (row, launches)."""
    import shutil

    from yolov3_tpu_torch.config import get_anchors, read_class_names
    from yolov3_tpu_torch.data.tfrecord import iter_tfrecord_records, parse_example
    from yolov3_tpu_torch.export import GraphModel
    from yolov3_tpu_torch.io.resolve import load_weights
    from yolov3_tpu_torch.models import apply_model, fold_batch_norm, init_model
    from yolov3_tpu_torch.models.network import to_device
    from yolov3_tpu_torch.tools import export_tfjs, run_js_pipeline

    shutil.rmtree(BROWSER_DIR, ignore_errors=True)
    os.makedirs(BROWSER_DIR)
    os.makedirs(TRANSFER_DIR, exist_ok=True)
    failures = []

    # (a) the export, twice per format from one fold
    ckpt, ckpt_source = darknet_backbone()
    model_file = os.path.join(ROOT, "config/models/yolov3/model.yaml")
    coco = os.path.join(ROOT, "datasets/coco2012/coco.names")
    t0 = time.monotonic()
    prebuilt = export_tfjs.load_folded_model(model_file, ckpt, coco)
    fold_s = time.monotonic() - t0
    exports = {}
    for fmt, quantize in (("float32", None), ("uint8", "uint8")):
        runs = [timed_export(export_tfjs, model_file, ckpt, coco, prebuilt,
                             os.path.join(BROWSER_DIR, f"yolov3_{fmt}_{i}"), quantize)
                for i in (1, 2)]
        exports[fmt] = dict(seconds=[r[0] for r in runs], mb=runs[0][1], sha256=runs[0][2],
                            identical=runs[0][2] == runs[1][2])
        if not exports[fmt]["identical"]:
            failures.append(f"the {fmt} export differs between two runs")
    log(f"browser export ({ckpt_source} checkpoint, fold {fold_s:.2f} s) {json.dumps(exports)}")

    # (b) the executor on the card against the eager forward
    spec, _ = prebuilt
    val = os.path.join(ROOT, "datasets/shapes_toy/tfrecords/val/file_00.tfrec")
    val_jpg = os.path.join(BROWSER_DIR, "val_000.jpg")
    with open(val_jpg, "wb") as f:
        f.write(parse_example(next(iter_tfrecord_records(val)))["image/encoded"][0])
    from yolov3_tpu_torch.data.image import decode_image, resize_bilinear

    with open(val_jpg, "rb") as f:
        x = resize_bilinear(decode_image(f.read()).astype(np.float32), 416, 416)[None] / 255.0
    x = torch.from_numpy(x.astype(np.float32)).cuda()
    params, state = load_weights(spec, *init_model(spec, torch.Generator().manual_seed(0)), ckpt)
    folded = to_device(fold_batch_norm(params, state), "cuda")
    executor_row = {}
    with torch.inference_mode():
        def eager():
            return sorted(apply_model(spec, folded, {}, x), key=lambda o: o.shape[1])

        want = eager()
        for fmt in ("float32", "uint8"):
            t0 = time.monotonic()
            graph = GraphModel(os.path.join(BROWSER_DIR, f"yolov3_{fmt}_1"), device="cuda")
            load_s = time.monotonic() - t0
            got = graph(x)
            rel = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
            executor_row[fmt] = dict(load_s=load_s, head_rel_err=rel,
                                     shapes=[list(g.shape) for g in got],
                                     finite=all(bool(torch.isfinite(g).all()) for g in got))
            if fmt == "float32":
                executor_row[fmt]["b1_ms"] = cuda_ms(lambda: graph(x), 20)
                if max(rel) > BROWSER_TOL or [g.shape for g in got] != [w.shape for w in want]:
                    failures.append(f"executor heads off the eager forward: {rel}")
            elif not executor_row[fmt]["finite"]:
                failures.append("the uint8 export's heads are not finite")
            del graph
        executor_row["eager_b1_ms"] = cuda_ms(eager, 20)
    del folded, want
    torch.cuda.empty_cache()
    log(f"browser executor {json.dumps(executor_row)}")

    # (c) the JS pipeline through jsvm, GraphModelHost on the card
    tiny_dir = os.path.join(BROWSER_DIR, "tiny_float32")
    toy_names = os.path.join(ROOT, "datasets/shapes_toy/class.names")
    toy_anchors = os.path.join(ROOT, "datasets/shapes_toy/anchors/anchors_tiny.txt")
    export_tfjs.main(["--model_config_file", os.path.join(ROOT, "config/models/yolov3_tiny/"
                                                                "model.yaml"),
                      "--weights_path", os.path.join(ROOT, "checkpoints/output/"
                                                           "yolov3_train_tiny.tf"),
                      "--classes_name_file", toy_names, "--tfjs_out_dir", tiny_dir])
    nms_kernel.suppression_sweep.launches = round_sweep.round_sweep.launches = 0
    tiny, tiny_s, tiny_out = run_js(run_js_pipeline, "--model_dir", tiny_dir, "--image", val_jpg,
                                    "--classes", toy_names, "--anchors", toy_anchors)
    full, full_s, full_out = run_js(run_js_pipeline, "--model_dir",
                                    os.path.join(BROWSER_DIR, "yolov3_float32_1"))
    py = full["python"]
    with torch.inference_mode():
        n = py["decoded"][0].shape[1]
        exact = nms_mod.yolo_nms_exact(*py["decoded"])
        at_n = nms_mod.yolo_nms(*py["decoded"], num_candidates=n)
    torch.cuda.synchronize()
    launches = dict(nms_sweep=nms_kernel.suppression_sweep.launches,
                    round_sweep=round_sweep.round_sweep.launches)
    with open(os.path.join(BROWSER_DIR, "run_js_pipeline.txt"), "w") as f:
        f.write(tiny_out + full_out)

    tiny_cmp = tiny["compare"]
    witness = None
    if not (tiny_cmp["classes_match"] and tiny_cmp["box_delta"] <= NEAR_TIE
            and tiny_cmp["score_delta"] <= NEAR_TIE):
        tpy = tiny["python"]
        g_boxes, g_scores = js_decoded(tpy["heads"], get_anchors(toy_anchors),
                                       len(read_class_names(toy_names)))
        pb, pc, pp = (t[0].cpu() for t in tpy["decoded"])
        witness = near_tie_witness(nms_mod, g_boxes, g_scores, pb,
                                   pc[:, 0] * pp.max(-1).values,
                                   dict(iou_threshold=0.5, score_threshold=0.1))
        if witness["margin"] is None or witness["margin"] > NEAR_TIE:
            failures.append(f"tiny: the JS detections differ from the compare leg's "
                            f"without a near tie: {tiny_cmp} {witness}")
    names = read_class_names(coco)
    well_formed = all(len(d["box"]) == 4 and 0.1 < d["score"] <= 1.0
                      and d["className"] in names for d in full["detections"])
    same_at_n = all(torch.equal(a, b) for a, b in zip(exact[3:], at_n[3:]))
    if full["compare"]["n_python"] != len(full["detections"]) or not well_formed:
        failures.append(f"yolov3: the JS pipeline breaks its contract {full['compare']}")
    if tiny["leaked_tensors"] or full["leaked_tensors"]:
        failures.append("the browser port left tensors live")
    if not same_at_n:
        failures.append("yolo_nms at K = N differs from yolo_nms_exact")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        failures.append(f"the JS pipeline's compare legs launched none of {missing}")
    row = dict(checkpoint=ckpt_source, fold_s=fold_s, exports=exports, executor=executor_row,
               js_tiny=dict(seconds=tiny_s, detections=len(tiny["detections"]),
                            compare=tiny_cmp, near_tie_witness=witness),
               js_yolov3=dict(seconds=full_s, detections=len(full["detections"]),
                              compare=full["compare"], n=n,
                              detections_at_k_n=int(at_n[4][0]), same_at_k_n=same_at_n,
                              leaked=full["leaked_tensors"]),
               launches=launches, card=smi)
    log(f"browser {json.dumps(row)}")
    if failures:
        raise AssertionError("browser: " + "; ".join(failures))
    return row, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; this script runs the port on the card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--load-artifact"]:  # phase 23's process of its own
        return artifact_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--dp-worker"]:  # a rank of phase 24
        return dp_worker(*sys.argv[2:])
    if sys.argv[1:2] == ["--multihost-smoke"]:  # a rank of phase 29's multihost_smoke
        return multihost_rank(*sys.argv[2:])
    from yolov3_tpu_torch import models
    from yolov3_tpu_torch.apps import inference_app, serve_app
    from yolov3_tpu_torch.ops import decode
    from yolov3_tpu_torch.ops import nms as nms_mod
    from yolov3_tpu_torch.ops.cuda import (bias_act, bn_leaky, bn_stats, build, conv1x1,
                                           conv_int8, nms_kernel, resblock, round_sweep)

    # the native data-loader core, built once before any phase decodes
    import dataclasses

    from yolov3_tpu_torch.data.native_build import ensure_native_library

    native_build = ensure_native_library()
    log(f"native build: {json.dumps(dataclasses.asdict(native_build))}")

    # phase 1 — card identity and the fp32 settings
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    fp32_settings()
    from yolov3_tpu_torch.device import fp32_precision

    log(f"torch {torch.__version__} cuda {torch.version.cuda}; cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} matmul precision="
        f"{torch.get_float32_matmul_precision()}; the port reads fp32 as {fp32_precision()}")

    # phase 2 — build: the kernels, and beside them K2's latency-floor probe
    # (kernel_times.round_floor, a library of its own), all nvcc at once
    from yolov3_tpu_torch.ops.cuda import kernel_times

    probe = threading.Thread(target=kernel_times.build_probes, args=(
        {"round_floor": (os.path.join(kernel_times.PROBES, "round_floor.cu"), {})},))
    probe.start()
    build.build_all()
    probe.join()
    log(f"kernels built in {build.build_seconds:.1f}s into {build.BUILD_DIR}")

    k1 = timed("K1", phase_k1, nms_kernel)
    k2 = timed("K2", phase_k2, round_sweep)
    serve_rows, launches, k8_served = timed("serve fp32 + bf16", phase_serve, inference_app,
                                            serve_app, models, decode, nms_mod, nms_kernel,
                                            round_sweep)
    timed("trained tiny", phase_trained, inference_app, models, decode, nms_mod)

    # the int8 tiers: kernels against their plain versions, the full-width
    # forward, K4's stage runs, then the int8 tier served (K3 and K6 counted
    # over that window alone) and the trained tiny model
    k3 = timed("K3", phase_k3, conv1x1)
    k6 = timed("K6", phase_k6, conv_int8)
    bodies = encoded_requests()
    int8_rows, chain, batch = timed("int8 forward", phase_int8_forward, models, inference_app,
                                    bodies, conv1x1, conv_int8)
    k4, k4_launches = timed("K4", phase_k4, models, resblock, chain, batch)
    del chain, batch
    torch.cuda.empty_cache()
    conv1x1.conv1x1_int8_requant.launches = conv_int8.conv_int8.launches = 0
    _, int8_serve = timed("serve int8", serve_tier, "int8", inference_app, serve_app, bodies)
    # K4's count: the int8_chain forward of phase 9 (reset just before it);
    # phase 10's stage runs (k4_launches) drive the stages one by one
    chain_row = next(r for r in int8_rows if r["mode"] == "int8_chain")
    launches.update(conv1x1_int8=conv1x1.conv1x1_int8_requant.launches,
                    conv_int8=conv_int8.conv_int8.launches,
                    resblock_int8=chain_row["launches_per_forward"]["resblock_int8"])
    log(f"int8 serving launches {json.dumps(launches)}")
    if launches["conv1x1_int8"] == 0 or launches["conv_int8"] == 0:
        raise AssertionError(f"the int8 tier served without K3 or K6: {launches}")
    serve_rows.append(int8_serve)
    timed("trained tiny int8", phase_trained_int8, inference_app, models, nms_mod)

    # the trainer: K5 and K7 against their plain versions, one step against
    # the CPU, then Train itself with K5's and K7's counts set to 0 just
    # before each run
    torch.cuda.empty_cache()
    k5 = timed("K5", phase_k5, bn_stats)
    k7, k7_sums = timed("K7", phase_k7, bn_leaky, bn_stats)
    k8 = timed("K8", phase_k8, bias_act)
    train_step_row = timed("train step vs CPU", phase_train_step_vs_cpu, models, bn_stats, bodies)
    train_rows, k5_launches, k7_launches = timed("trainer", phase_trainer, inference_app,
                                                 bn_stats, bn_leaky, bodies, smi)
    launches["bn_stats"] = k5_launches[0]
    launches["bn_leaky"] = k7_launches[0]
    if min(k5_launches) == 0 or min(k7_launches) == 0:
        raise AssertionError(f"the trainer ran without K5 or K7: {k5_launches} {k7_launches}")

    # the offline entry points: evaluation, the int8 gate, batch inference;
    # each run's kernel counts are set to 0 just before it and read just after
    from yolov3_tpu_torch.apps import evaluate_app

    torch.cuda.empty_cache()
    eval_rows, eval_launches = timed("eval tiny", phase_eval_tiny, evaluate_app, nms_mod,
                                     nms_kernel, round_sweep)
    full_rows, full_launches = timed("eval yolov3", phase_eval_full, evaluate_app, models,
                                     nms_kernel, round_sweep)
    gate_row, gate_launches = timed("int8 gate", phase_gate, inference_app, conv1x1, conv_int8,
                                    smi)
    infer_row, infer_launches = timed("inference", phase_inference, inference_app, nms_mod,
                                      nms_kernel, round_sweep, resblock, conv1x1, conv_int8)
    offline = {"eval tiny": eval_launches, "eval yolov3": full_launches,
               "int8 gate": gate_launches, "inference": infer_launches}
    for path in offline.values():
        for name, count in path.items():
            launches[name] += count
    log(f"offline launches {json.dumps(offline)}")

    # the trainer's extras; K5's count of the all-keys run, set to 0 just
    # before it, joins the trainer's
    torch.cuda.empty_cache()
    extras, extras_launches = timed("trainer extras", phase_train_extras, inference_app,
                                    bn_stats, bodies, smi)
    launches["bn_stats"] += extras_launches[0]
    k5_launches[1] += extras_launches[1]

    # the model-file entry points: a Darknet file converted and served (K1,
    # K3, K4, K6 and K8 counted over the int8_chain serving call), then phase
    # 15's checkpoint recalibrated (K5 counted over the card's run)
    torch.cuda.empty_cache()
    convert_row, convert_launches = timed("convert", phase_convert, inference_app, bodies,
                                          nms_kernel, conv1x1, conv_int8, resblock, smi)
    for name, count in convert_launches.items():
        launches[name] += count
    recal_row, recal_launches = timed("recalibrate", phase_recalibrate, inference_app,
                                      bn_stats, bodies, smi)
    launches["bn_stats"] += recal_launches[0]
    k5_launches[1] += recal_launches[1]

    # the serving artifact: K1, K3, K4 and K6 counted over one loaded B=16
    # call of each tier, the counts set to 0 just before it
    torch.cuda.empty_cache()
    artifact_row, artifact_launches = timed("artifact", phase_artifact, inference_app, serve_app,
                                            nms_mod, bodies, nms_kernel, conv1x1, conv_int8,
                                            resblock, smi)
    for counts in artifact_launches.values():
        for name, count in counts.items():
            launches[name] += count

    # data parallelism: K5 counted over every rank of (a) and (b), each rank a
    # process of its own that starts at 0; K1, K3, K4 and K6 over the sharded
    # int8_chain and fp32 B=16 calls of (c), the counts set to 0 just before
    torch.cuda.empty_cache()
    dp_row, dp_k5, dp_serve_launches = timed("data parallel", phase_dp, inference_app,
                                             serve_app, nms_kernel, conv1x1, conv_int8,
                                             resblock, bodies, smi)
    launches["bn_stats"] += dp_k5["forward"]
    k5_launches[1] += dp_k5["backward"]
    for name, count in dp_serve_launches.items():
        launches[name] += count

    # the spatial axis: every count set to 0 just before each of its runs
    # ((a)'s B=16 and B=1 calls, (b)'s step, (c)'s ranks, (d)'s request,
    # (e)'s sweep) and read just after
    torch.cuda.empty_cache()
    spatial_row, spatial_launches = timed("spatial", phase_spatial, inference_app, serve_app,
                                          evaluate_app, nms_kernel, round_sweep, conv1x1,
                                          conv_int8, resblock, bn_stats, bodies, smi)
    for name, count in spatial_launches.items():
        launches[name] += count
    k5_launches[1] += spatial_row["b_training"]["k5_launches"]["backward"]

    # YOLOv4 at 608²: the card tests, its tails and its Mish kernels
    torch.cuda.empty_cache()
    yolov4_row = timed("yolov4", phase_yolov4, smi)

    # the training-quality recipe: K5 counted over its training run, K1, K3
    # and K6 over its three evaluations, each set to 0 just before
    torch.cuda.empty_cache()
    convergence_row, convergence_launches = timed("convergence", phase_convergence, nms_kernel,
                                                  conv1x1, conv_int8, bn_stats, bodies, smi)
    launches["bn_stats"] += convergence_launches["bn_stats"]["forward"]
    k5_launches[1] += convergence_launches["bn_stats"]["backward"]
    for name in ("nms_sweep", "conv1x1_int8", "conv_int8"):
        launches[name] += convergence_launches[name]

    # the custom-dataset workflow: K5 (each way), K1, K3 and K6 counted over
    # each transfer run, K1 over the scale matrix, each set to 0 just before
    torch.cuda.empty_cache()
    transfer_row, transfer_launches = timed("transfer", phase_transfer, nms_kernel, conv1x1,
                                            conv_int8, bn_stats, smi)
    launches["bn_stats"] += transfer_launches["bn_stats"]["forward"]
    k5_launches[1] += transfer_launches["bn_stats"]["backward"]
    for name in ("nms_sweep", "conv1x1_int8", "conv_int8", "bias_act"):
        launches[name] += transfer_launches[name]
    torch.cuda.empty_cache()
    tools_row, tools_launches = timed("dataset tools", phase_dataset_tools, nms_kernel, smi)
    launches["nms_sweep"] += tools_launches["nms_sweep"]

    # the measurement tools: every count set to 0 just before each tool and
    # read just after; multihost_smoke's ranks count their own
    torch.cuda.empty_cache()
    measure_row, measure_launches = timed("measurement tools", phase_measurement_tools,
                                          convergence_row, smi, native_build.tier)
    for name in (K1, K2, K3, K4, K6):
        launches[name] += measure_launches[name]
    launches["bn_stats"] += measure_launches[f"{K5}_forward"]
    k5_launches[1] += measure_launches[f"{K5}_backward"]
    launches["bn_leaky"] += measure_launches[f"{K7}_forward"]
    k7_launches[1] += measure_launches[f"{K7}_backward"]

    # the browser port: K1 and K2 counted over the JS pipeline's compare legs
    # and the K = N run, set to 0 just before
    torch.cuda.empty_cache()
    browser_row, browser_launches = timed("browser", phase_browser, nms_mod, nms_kernel,
                                          round_sweep, smi)
    for name, count in browser_launches.items():
        launches[name] += count

    k5_main = next(r for r in k5 if r["dtype"] == "float32" and r["shape"][1] == 32
                   and r["shape"][2] == 416
                   and r["memory"] == train_step_row.get("main_memory_format", "nchw"))

    def kernel_row(name, source, replaces, shapes, main, library=True):
        return dict(name=name, route="cuda", source=f"yolov3_tpu_torch/ops/cuda/csrc/{source}",
                    replaces=replaces, launches=launches[name],
                    equal_to_plain=all(r["equal"] for r in shapes),
                    max_abs_err=max(r["max_abs_err"] for r in shapes), ms=main["ms"],
                    plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                    bound_by=main.get("bound_by", "bytes"),
                    library_ms=main["library_ms"] if library else None, shapes=shapes)

    # each kernel's row: times at its first (main-path) shape; K4's at the 52²
    # stage, where 8 of Darknet-53's 23 blocks run
    kernels = [
        kernel_row("nms_sweep", "nms_sweep.cu", "yolov3_tpu/ops/pallas/nms_kernel.py:76", k1,
                   k1[0], library=False),
        # K2 at B=16, N=10,647 with its latency floor (100 rounds of its exchange)
        dict(kernel_row("round_sweep", "round_sweep.cu",
                        "yolov3_tpu/ops/pallas/round_sweep.py:110", k2, k2[0], library=False),
             device_us=k2[0]["device_us"], floor_ms=k2[0]["floor_ms"]),
        kernel_row("conv1x1_int8", "conv1x1_int8.cu", "yolov3_tpu/ops/pallas/conv1x1.py:111",
                   k3, k3[0]),
        dict(kernel_row("resblock_int8", "resblock_int8.cu",
                        "yolov3_tpu/ops/pallas/resblock.py:189", k4, k4[2], library=False),
             device_us=k4[2]["device_us"], stage_run_launches=k4_launches),
        kernel_row("conv_int8", "conv_int8.cu", "yolov3_tpu/models/layers.py:256", k6, k6[0]),
        # K5 at the largest BN input (C=32, 416², f32) in the memory format the
        # main path showed; its backward kernel's numbers ride along
        dict(kernel_row("bn_stats", "bn_stats.cu", "yolov3_tpu/ops/pallas/bn_stats.py:89", k5,
                        k5_main),
             backward_launches=k5_launches[1], backward_ms=k5_main["backward_ms"],
             sync_launches=dict(forward=dp_k5["sync_forward"],
                                backward=dp_k5["sync_backward"]),
             backward_plain_ms=k5_main["backward_plain_ms"],
             backward_bound_ms=k5_main["backward_bound_ms"],
             new_inputs=[{k: r[k] for k in ("input", "shape", "dtype", "equal", "device_us",
                                            "without_device_us")}
                         for r in extras["k5_new_inputs"]]),
        # K7 at YOLOv3-416's largest BN tail (C=32, 416², B=64, bf16,
        # channels-last: the train cell's), its backward beside it, and the
        # sums over the model's 72 tails each way
        dict(kernel_row("bn_leaky", "bn_leaky.cu", "yolov3_tpu/models/layers.py:342+407", k7,
                        k7[0], library=False),
             device_us=k7[0]["device_us"], share_of_bound=k7[0]["share_of_bound"],
             backward_launches=k7_launches[1], backward_ms=k7[0]["backward_ms"],
             backward_device_us=k7[0]["backward_device_us"],
             backward_plain_ms=k7[0]["backward_plain_ms"],
             backward_bound_ms=k7[0]["backward_bound_ms"],
             backward_share_of_bound=k7[0]["backward_share_of_bound"], model_sums=k7_sums),
        # K8 at YOLOv3-416's largest fp tail (leaky, C=32, 416², B=8, bf16,
        # channels-last); its launches over the main-path runs that count it,
        # and one served call of each predictor (phases 5 and 25b) with every
        # fp tail through it
        dict(name="bias_act", route="cuda", source="yolov3_tpu_torch/ops/cuda/csrc/bias_act.cu",
             replaces="yolov3_tpu/models/layers.py leaky_relu after the folded conv's bias",
             equal_to_plain=all(r["equal"] for r in k8), ms=k8[0]["ms"],
             device_us=k8[0]["device_us"], plain_ms=k8[0]["plain_ms"],
             host_us=k8[0]["host_us"], plain_host_us=k8[0]["plain_host_us"],
             bound_ms=k8[0]["bound_ms"], bound_by="bytes",
             share_of_bound=k8[0]["share_of_bound"], library_ms=None,
             launches=launches["bias_act"], routed=dict(k8_served, **yolov4_row["k8"]),
             shapes=k8),
    ]
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels, "serve": serve_rows, "int8_forward": int8_rows,
                    "train_step_vs_cpu": train_step_row, "train": train_rows,
                    "eval_tiny": eval_rows, "eval_yolov3": full_rows, "int8_gate": gate_row,
                    "inference": infer_row, "offline_launches": offline,
                    "train_extras": extras, "convert": convert_row,
                    "recalibrate": recal_row, "artifact": artifact_row,
                    "data_parallel": dp_row, "spatial": spatial_row, "yolov4": yolov4_row,
                    "convergence": convergence_row, "transfer": transfer_row,
                    "dataset_tools": tools_row, "measurement_tools": measure_row,
                    "browser": browser_row, "native_build": dataclasses.asdict(native_build),
                    "card": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
