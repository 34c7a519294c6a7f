"""Time K1 (``nms_sweep``), K2 (``round_sweep``), K3 (``conv1x1_int8``), K4
(``resblock_int8``), K5 (``bn_stats``) and K6 (``conv_int8``) alone on the card,
at the shapes ``chip_smoke.py`` holds them at, K7 (``bn_leaky``) at every
BatchNorm tail of the two train configurations, K8 (``bias_act``) at every
folded fp conv's tail of the two bf16 serving configurations, and the exact
NMS's escalation.

    PYTHONPATH=. python3 yolov3_tpu_torch/ops/cuda/kernel_times.py [k1 … k8] [nms]
    PYTHONPATH=. python3 yolov3_tpu_torch/ops/cuda/kernel_times.py k4parts k2threads
    PYTHONPATH=<other checkout> python3 yolov3_tpu_torch/ops/cuda/kernel_times.py k2 k4

The script imports the ``yolov3_tpu_torch`` that ``PYTHONPATH`` names and uses
only the wrappers' public functions, so the second form times another
checkout's kernels (say the parent commit's, unpacked with ``git archive``)
on the same card in the same run: run the two in turns to compare them.
The arguments pick what to time (K1–K8 without any). One JSON line a
shape: ``ms``, the mean milliseconds of a call over a loop between two CUDA
events (the larger of the host's cost of a call and the device's), and for
K1–K4 ``device_us``, the device microseconds of one call from torch.profiler
(each kernel the call launches: the median of its launches over 20 calls in
a row times its launches a call, summed). K4 is timed beside the unfused
chain it replaces (K3 → K6 → ``add_requant`` on the same block), K2 beside
its design's latency floor when the package is this script's own. ``nms``
times ``yolo_nms_exact`` escalating by doubling against jumping to K = N,
and ``yolo_nms`` at K = 256, 512 and 1,024 (K1 takes K ≤ 1,300) and B = 16,
4, 1 through the matrix sweep (K1) against the round sweep (K2) on the top
K. Two arguments time what a kernel's design spends its time on:
``k4parts`` builds K4's source again with one part left out at a time
(``RESBLOCK_CUT``: the squeeze, the expand, the expand's products, the
shortcut epilogue) and times each beside the whole kernel at K4's shapes;
``k2threads`` times K2 at its plan's cluster with 64 to 1,024 threads a
block. ``k7`` times K7 forward and backward at each distinct BatchNorm tail
of YOLOv3-416 at B=64 and YOLOv3-tiny at B=128 (bf16, both memory layouts)
beside its bytes bound (forward: x read, y written; backward: x and dy
read, dx written; at 3.35 TB/s) and the plain expression it replaced
(forward, and autograd's backward of it), then each model's sum over its
tails, a tail counted as often as the model has it, with the bound's share
of the summed device time each way. ``k8`` times K8 at each distinct fp tail
of YOLOv3-416 at B=128 and YOLOv4-608 at B=64 (bf16, both memory layouts,
a bf16 bias as the bf16 predictor holds it) beside its bytes bound (x read,
y written, the bias read) and the plain expression it replaced (the add,
then ``where`` or ATen's Mish), with K8's bits against the plain
expression's, then each model's sums over its tails as ``k7``'s.

The probes this needs beside the kernels (K2's latency floor,
``probes/round_floor.cu``, and K4's variants) are built by ``build_probes``
into a directory of their own, never into the kernels' libraries. Needs a
card; nothing here runs on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SAME, TOP_LEFT = ((1, 1), (1, 1)), ((1, 0), (1, 0))
# (name, batch, input height = width, Cin, Cout, kernel, stride, padding): the
# main-path shape first, then the strided conv of that stage, both convs of the
# space-to-depth stem, one 3×3 stride-1 conv per stage of YOLOv3-416 at B=16,
# and the head's 13² conv at the serving buckets 1 and 4
K6_SHAPES = (
    ("3x3 s1 26^2 256->512", 16, 26, 256, 512, 3, 1, SAME),
    ("3x3 s2 52^2->26^2 256->512", 16, 52, 256, 512, 3, 2, TOP_LEFT),
    ("s2d stem conv0 4x4 s2 416^2 3->128", 16, 416, 3, 128, 4, 2, ((1, 2), (1, 2))),
    ("s2d stem conv1 2x2 s1 208^2 128->64", 16, 208, 128, 64, 2, 1, TOP_LEFT),
    ("3x3 s1 208^2 32->64", 16, 208, 32, 64, 3, 1, SAME),
    ("3x3 s1 104^2 64->128", 16, 104, 64, 128, 3, 1, SAME),
    ("3x3 s1 52^2 128->256", 16, 52, 128, 256, 3, 1, SAME),
    ("3x3 s1 13^2 512->1024", 16, 13, 512, 1024, 3, 1, SAME),
    ("3x3 s1 13^2 512->1024 B=1", 1, 13, 512, 1024, 3, 1, SAME),
    ("3x3 s1 13^2 512->1024 B=4", 4, 13, 512, 1024, 3, 1, SAME),
)
# (name, M, Cin, Cout, launches in one B=16 int8 forward): every quantized 1×1
# conv of YOLOv3-416 at B=16 (the main-path shape first), and the 13² head
# conv at the serving buckets 1 and 4
K3_SHAPES = (
    ("208^2 64->32", 16 * 208 * 208, 64, 32, 1),
    ("104^2 128->64", 16 * 104 * 104, 128, 64, 2),
    ("52^2 256->128", 16 * 52 * 52, 256, 128, 10),
    ("52^2 384->128", 16 * 52 * 52, 384, 128, 1),
    ("26^2 512->256", 16 * 26 * 26, 512, 256, 10),
    ("26^2 768->256", 16 * 26 * 26, 768, 256, 1),
    ("26^2 256->128", 16 * 26 * 26, 256, 128, 1),
    ("13^2 1024->512", 16 * 13 * 13, 1024, 512, 7),
    ("13^2 512->256", 16 * 13 * 13, 512, 256, 1),
    ("13^2 1024->512 B=1", 13 * 13, 1024, 512, 0),
    ("13^2 1024->512 B=4", 4 * 13 * 13, 1024, 512, 0),
)
# (B, K) of K1: the serving bucket K=512 at B=16 (the main path), 1 and 4
K1_CASES = ((16, 512), (1, 512), (4, 512))
IOU_THR = 0.5
# (B, N) of K2: the 416² and 608² candidate counts at B = 16 (the main path),
# and at the serving buckets 1 and 4; 100 rounds at score threshold 0.004
K2_CASES = ((16, 10647), (16, 22743), (1, 10647), (4, 10647), (1, 22743), (4, 22743))
K2_SCORE_THR = 0.004
# (H = W, C) of the five residual stages of Darknet-53 at 416² (Cm = C/2), and
# the batches K4 is timed at: B = 16 at every stage, the serving buckets at 13²
K4_STAGES = ((208, 64), (104, 128), (52, 256), (26, 512), (13, 1024))
K4_CASES = tuple((16, hw, c) for hw, c in K4_STAGES) + ((1, 13, 1024), (4, 13, 1024))
# (B, C, H, W) BatchNorm inputs of YOLOv3-416 at B=16, and one odd shape
K5_SHAPES = ((16, 32, 416, 416), (16, 64, 208, 208), (16, 256, 52, 52), (16, 512, 26, 26),
             (16, 1024, 13, 13), (3, 32, 5, 7))
# K7: (model, batch, {(C, H = W): BatchNorm tails of that shape}) of the two
# train configurations at 416
K7_TAILS = (
    ("yolov3", 64, {(32, 416): 1, (32, 208): 1, (64, 208): 2, (64, 104): 2, (128, 104): 3,
                    (128, 52): 11, (256, 52): 12, (128, 26): 1, (256, 26): 11, (512, 26): 12,
                    (256, 13): 1, (512, 13): 7, (1024, 13): 8}),
    ("yolov3_tiny", 128, {(16, 416): 1, (32, 208): 1, (64, 104): 1, (128, 52): 1, (256, 26): 2,
                          (128, 13): 1, (256, 13): 1, (512, 13): 2, (1024, 13): 1}))
# K8: (model, batch, {(activation, C, H = W): fp conv tails of that shape}) of
# the two bf16 serving cells
K8_TAILS = (
    ("yolov3", 128, {("leaky", 32, 416): 1, ("leaky", 64, 208): 2, ("leaky", 32, 208): 1,
                     ("leaky", 128, 104): 3, ("leaky", 64, 104): 2, ("leaky", 256, 52): 12,
                     ("leaky", 128, 52): 11, ("leaky", 512, 26): 12, ("leaky", 256, 26): 11,
                     ("leaky", 128, 26): 1, ("leaky", 1024, 13): 8, ("leaky", 512, 13): 7,
                     ("leaky", 256, 13): 1, ("linear", 255, 52): 1, ("linear", 255, 26): 1,
                     ("linear", 255, 13): 1}),
    ("yolov4", 64, {("mish", 32, 608): 1, ("mish", 64, 304): 6, ("mish", 32, 304): 1,
                    ("mish", 128, 152): 2, ("mish", 64, 152): 7, ("mish", 256, 76): 2,
                    ("mish", 128, 76): 19, ("mish", 512, 38): 2, ("mish", 256, 38): 19,
                    ("mish", 1024, 19): 2, ("mish", 512, 19): 11, ("leaky", 256, 76): 3,
                    ("leaky", 128, 76): 4, ("leaky", 512, 38): 5, ("leaky", 256, 38): 8,
                    ("leaky", 128, 38): 1, ("leaky", 1024, 19): 5, ("leaky", 512, 19): 8,
                    ("leaky", 256, 19): 1, ("linear", 255, 76): 1, ("linear", 255, 38): 1,
                    ("linear", 255, 19): 1}))
HBM_BYTES_PER_S = 3.35e12


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


def conv_case(batch, hw, cin, cout, k):
    """Seeded int8 input, weights and epilogue vectors of one K6 shape, on the card."""
    rng = np.random.RandomState(cout + k)
    cuda = lambda a: torch.as_tensor(a).cuda()  # noqa: E731
    return (cuda(rng.randint(-127, 128, (batch, hw, hw, cin)).astype(np.int8)),
            cuda(rng.randint(-127, 128, (cout, k, k, cin)).astype(np.int8)),
            cuda((rng.rand(cout) * 2e-5 + 1e-6).astype(np.float32)),
            cuda(rng.randn(cout).astype(np.float32)), cuda(np.float32([1 / 0.0529])))


PAD_LAUNCHES = 1000         # short torch.cuda._sleep launches on each side of a window
PAD_SPIN_CYCLES = 20_000_000  # then one long spin: 10–12 ms at the H100's clocks
PROFILER_WINDOWS = 3


def _pad():
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(64)
    torch.cuda._sleep(PAD_SPIN_CYCLES)
    torch.cuda.synchronize()


def is_range_span(event) -> bool:
    """Whether a device record is a profiler range's span on the device (a
    ``record_function`` range, such as ``models/network.py``'s layer ranges
    ``L|…``, shows on the device's timeline over the kernels it launched),
    not a kernel: counting it would count those kernels twice."""
    return bool(getattr(event, "is_user_annotation", False)) or event.name.startswith("L|")


def profile_window(run):
    """``run()`` once under torch.profiler → (the profile, host ms of the call,
    [(start, kernel name, device µs), ...] of the device records it made, in
    the order the device started them; ranges' device spans left out,
    ``is_range_span``).

    The profiler on the H100 machine drops device records at a window's
    edges: the first few of a window, and, as its device clock drifts against
    the host's over a process's life, whole records near either edge. So
    ``run`` sits between two pads of ``torch.cuda._sleep`` launches (a
    thousand short ones, then one of 10–12 ms) whose records are left out,
    and a window whose records of ``run`` are not bracketed by pad records on
    both sides is opened again, up to ``PROFILER_WINDOWS`` times; the last
    one is returned as it came. A window opened again is noted on stderr."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _pad()
            t0 = time.perf_counter()
            run()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            _pad()
        records = sorted(
            (e.time_range.start, e.name,
             getattr(e, "device_time", 0) or getattr(e, "cuda_time", 0) or 0)
            for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not is_range_span(e))
        pads = [i for i, r in enumerate(records) if "spin_kernel" in r[1]]
        own = [i for i, r in enumerate(records) if "spin_kernel" not in r[1]]
        if own and pads and pads[0] < own[0] and pads[-1] > own[-1]:
            break
        print(f"profile_window: {len(own)} records of the call, {len(pads)} of the pads, "
              "not bracketed; opening the window again", file=sys.stderr, flush=True)
    return prof, host_ms, [records[i] for i in own]


def device_us(fn, calls=20):
    """Device µs of one call of ``fn``: torch.profiler over ``calls`` calls in a
    row (``profile_window``); for each kernel they launch, the median of its
    launches times its launches a call, summed."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()

    by_name = {}
    for _, name, us in profile_window(run)[2]:
        by_name.setdefault(name, []).append(us)
    return (sum(float(np.median(v)) * len(v) / calls for v in by_name.values())
            if by_name else None)


def conv1x1_case(m, cin, cout):
    """Seeded int8 activations, weights and epilogue vectors of one K3 shape,
    on the card."""
    rng = np.random.RandomState(cout)
    cuda = lambda a: torch.as_tensor(a).cuda()  # noqa: E731
    return (cuda(rng.randint(-127, 128, (m, cin)).astype(np.int8)),
            cuda(rng.randint(-127, 128, (cout, cin)).astype(np.int8)),
            cuda((rng.rand(cout) * 2e-4 + 1e-5).astype(np.float32)),
            cuda(rng.randn(cout).astype(np.float32)), cuda(np.float32([1 / 0.0529])))


def sweep_case(b, k):
    """Seeded K1 input on the card: the IoU > 0.5 matrix of K random small
    boxes a image (as ``ops/nms.py`` builds it) and 60% of them valid."""
    from yolov3_tpu_torch.ops import nms

    rng = np.random.RandomState(k + b)
    xy = rng.rand(b, k, 2) * 0.8
    wh = rng.rand(b, k, 2) * 0.11 + 0.01
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).cuda()
    return (nms._pairwise_iou(boxes) > IOU_THR,
            torch.from_numpy(rng.rand(b, k) < 0.6).cuda())


def k2_case(b, n):
    """Seeded K2 input on the card: N boxes a image, 0.02–0.3 on a side,
    scattered over the unit square, and uniform scores (``chip_smoke.py``'s
    phase K2 at B = 16)."""
    rng = np.random.RandomState(n)
    xy = rng.rand(b, n, 2) * 0.8
    wh = rng.rand(b, n, 2) * 0.28 + 0.02
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return (torch.from_numpy(boxes).cuda(),
            torch.from_numpy(rng.rand(b, n).astype(np.float32)).cuda())


def block_case(b, hw, c, seed=0):
    """One residual block at (B, H = W, C, Cm = C/2) as the int8_chain tier
    holds it: the input as a ``QAct`` and the chain-mode quantized entries of
    its squeeze, expand and shortcut, seeded, with scales that keep every
    requant off its clip. Returns (x, squeeze, expand, shortcut)."""
    from yolov3_tpu_torch.models import layers

    rng = np.random.RandomState(seed + c)
    cm = c // 2
    cuda = lambda a: torch.as_tensor(a).cuda()  # noqa: E731

    def conv(cout, k, cin, w_scale):
        return dict(kernel_q=cuda(rng.randint(-127, 128, (cout, k, k, cin)).astype(np.int8)),
                    w_scale=cuda((w_scale * (0.5 + rng.rand(cout))).astype(np.float32)),
                    bias=cuda((rng.randn(cout) * 0.1).astype(np.float32)),
                    out_scale=cuda(np.float32(3.0 / 127)))

    s_x = np.float32(0.05)
    x = layers.QAct(cuda(rng.randint(-127, 128, (b, hw, hw, c)).astype(np.int8)), cuda(s_x))
    squeeze = conv(cm, 1, c, 1.0 / (s_x * 73.0 * 127 * c ** 0.5))
    expand = conv(c, 3, cm, 1.0 / ((3.0 / 127) * 40.0 * 73.0 * (9 * cm) ** 0.5))
    return x, squeeze, expand, dict(out_scale=cuda(np.float32(0.06)))


def exact_nms_case(b=16, n=10647, nc=80, seed=0):
    """Seeded decode outputs on the card for ``yolo_nms_exact``: boxes as K2's,
    objectness and class probabilities uniform."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2) * 0.8
    wh = rng.rand(b, n, 2) * 0.28 + 0.02
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return (torch.from_numpy(boxes).cuda(),
            torch.from_numpy(rng.rand(b, n, 1).astype(np.float32)).cuda(),
            torch.from_numpy(rng.rand(b, n, nc).astype(np.float32)).cuda())


def escalation_times(nms, boxes, conf, probs, turns=2, reps=5, num_candidates=64,
                     score_threshold=0.004):
    """``yolo_nms_exact`` on one batch with ``next_escalation_k`` jumping to
    K = N (the CUDA default the port took from the JAX package) against
    doubling, in turns: {policy: {"ms": [one per turn], "ks": [K of each
    yolo_nms the escalation ran]}}; also whether both gave the same answer."""
    policies = {"jump": lambda k, n, device: n, "double": lambda k, n, device: min(n, 2 * k)}
    real_next, real_nms = nms.next_escalation_k, nms.yolo_nms
    out = {name: dict(ms=[], ks=[]) for name in policies}
    answers = {}

    def recording(*args, **kw):
        ks.append(kw.get("num_candidates"))
        return real_nms(*args, **kw)

    def run():
        return nms.yolo_nms_exact(boxes, conf, probs, max_boxes=100, iou_threshold=IOU_THR,
                                  score_threshold=score_threshold,
                                  num_candidates=num_candidates)

    try:
        for turn in range(turns):
            for name in (("jump", "double") if turn % 2 == 0 else ("double", "jump")):
                nms.next_escalation_k = policies[name]
                ks = []
                nms.yolo_nms = recording
                answers[name] = run()
                nms.yolo_nms = real_nms
                out[name]["ks"] = ks
                with torch.inference_mode():
                    out[name]["ms"].append(cuda_ms(run, reps))
    finally:
        nms.next_escalation_k, nms.yolo_nms = real_next, real_nms
    same = all(torch.equal(a, b) for a, b in zip(answers["jump"][3:], answers["double"][3:]))
    return out, same


PROBES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probes")
# K4's variants with one part left out: (name, RESBLOCK_CUT; csrc/resblock_int8.cu)
K4_CUTS = (("whole kernel", 0), ("no squeeze", 1), ("no expand", 2),
           ("expand without its products", 3), ("no shortcut epilogue", 4))
_probe_libs = {}


def build_probes(variants):
    """Build measurement libraries, one ``nvcc`` each, all started together:
    ``variants`` {name: (source path, {macro: value})} → {name: ctypes.CDLL}.
    They go to ``<build dir>/probes``, named by a hash of the source, of every
    kernel source and header it may include, of the macros and the flags."""
    from yolov3_tpu_torch.ops.cuda import build

    out_dir = os.path.join(build.BUILD_DIR, "probes")
    os.makedirs(out_dir, exist_ok=True)
    shared = b"".join(open(os.path.join(build.CSRC, f), "rb").read()
                      for f in sorted(os.listdir(build.CSRC)))
    jobs = {}
    for name, (source, defines) in variants.items():
        if name in _probe_libs:
            continue
        flags = [f"-D{k}={v}" for k, v in sorted(defines.items())]
        digest = hashlib.sha256(open(source, "rb").read() + shared + " ".join(
            [*build.NVCC_FLAGS, *flags]).encode()).hexdigest()[:16]
        target = os.path.join(out_dir, f"{name.replace(' ', '_')}-{digest}.so")
        if os.path.exists(target):
            jobs[name] = (None, target)
            continue
        log = open(target[:-3] + ".log", "w")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", target + ".tmp", source]
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), target)
    for name, (proc, target) in jobs.items():
        if proc is not None:
            if proc.wait():
                with open(target[:-3] + ".log") as f:
                    raise RuntimeError(f"building the probe '{name}' failed:\n{f.read()}")
            os.replace(target + ".tmp", target)
        _probe_libs[name] = ctypes.CDLL(target)
    return {name: _probe_libs[name] for name in variants}


def round_floor(b: int, n: int, rounds: int):
    """K2's latency floor at ``round_sweep.plan(b, n)``'s shape: ``rounds``
    rounds of the kernel's exchange (a slot written, one cluster barrier, the
    slots read over distributed shared memory and folded) with no boxes, on
    the current card. Returns the checksum tensor it writes."""
    from yolov3_tpu_torch.ops.cuda import build, round_sweep

    lib = build_probes({"round_floor": (os.path.join(PROBES, "round_floor.cu"), {})})
    fn = lib["round_floor"].round_floor_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p], \
        ctypes.c_int
    pl = round_sweep.plan(b, n)
    sink = torch.empty((pl["grid"],), dtype=torch.int32, device="cuda")
    build.launch(fn, sink.device, "round_floor", sink.data_ptr(), b, pl["cluster"],
                 pl["threads"], rounds)
    return sink


def k4_part_launchers(build):
    """K4's launch function built as it is and with each part left out
    (``K4_CUTS``): {name: ctypes function}."""
    libs = build_probes({f"k4 {name}": (os.path.join(build.CSRC, "resblock_int8.cu"),
                                        {"RESBLOCK_CUT": cut}) for name, cut in K4_CUTS})
    launchers = {}
    for name, _ in K4_CUTS:
        fn = libs[f"k4 {name}"].resblock_int8_launch
        fn.argtypes = build.SIGNATURES["resblock_int8"]["resblock_int8_launch"]
        fn.restype = ctypes.c_int
        launchers[name] = fn
    return launchers


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card visible", file=sys.stderr)
        return 2
    import yolov3_tpu_torch
    from yolov3_tpu_torch.models import layers
    from yolov3_tpu_torch.ops import nms
    from yolov3_tpu_torch.ops.cuda import (bn_stats, conv1x1, conv_int8, nms_kernel, resblock,
                                           round_sweep)

    picked = set(argv) or {"k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8"}
    own_package = (os.path.realpath(os.path.dirname(yolov3_tpu_torch.__file__))
                   == os.path.realpath(os.path.join(PROBES, "..", "..", "..")))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(dict(card=card, package=os.path.dirname(yolov3_tpu_torch.__file__))),
          flush=True)
    for b, k in K1_CASES if "k1" in picked else ():
        mat, valid = sweep_case(b, k)
        call = lambda: nms_kernel.suppression_sweep(mat, valid)  # noqa: E731
        print(json.dumps(dict(kernel="nms_sweep", B=b, K=k, ms=cuda_ms(call, 50),
                              device_us=device_us(call))), flush=True)
    for b, n in K2_CASES if "k2" in picked else ():
        boxes, scores = k2_case(b, n)

        def call():
            return round_sweep.round_sweep(boxes, scores, IOU_THR, K2_SCORE_THR, 100)

        row = dict(kernel="round_sweep", B=b, N=n, ms=cuda_ms(call, 20), device_us=device_us(call))
        if own_package:   # the latency floor of this checkout's design
            def floor():
                return round_floor(b, n, 100)

            row.update(plan=round_sweep.plan(b, n), floor_100_rounds_ms=cuda_ms(floor, 20),
                       floor_100_rounds_device_us=device_us(floor))
        print(json.dumps(row), flush=True)
    for b, hw, c in K4_CASES if "k4" in picked else ():
        x, squeeze, expand, shortcut = block_case(b, hw, c)
        kwargs, _ = resblock.block_args(squeeze, expand, shortcut, x.scale)
        xp = resblock.to_halo(x.q)

        def fused():
            return resblock.fused_resblock(xp, **kwargs, b=b, h=hw, w=hw)

        def unfused():
            a = layers.conv2d_int8(x, squeeze, 1, 1, leaky=True)
            a = layers.conv2d_int8(a, expand, 1, 1, leaky=True)
            return layers.add_requant(x, a, shortcut["out_scale"])

        equal = torch.equal(resblock.from_halo(fused(), b, hw, hw), unfused().q)
        print(json.dumps(dict(kernel="resblock_int8", B=b, stage=f"{hw}^2 C={c}", equal=equal,
                              ms=cuda_ms(fused, 20), device_us=device_us(fused),
                              unfused_ms=cuda_ms(unfused, 20),
                              unfused_device_us=device_us(unfused))), flush=True)
        del x, xp, squeeze, expand
    if "k4parts" in picked:
        launchers = k4_part_launchers(resblock.build)
        for b, hw, c in K4_CASES[:6]:
            x, squeeze, expand, shortcut = block_case(b, hw, c)
            kwargs, _ = resblock.block_args(squeeze, expand, shortcut, x.scale)
            xp = resblock.to_halo(x.q)
            out = torch.empty_like(xp)
            pl = resblock.plan(b, hw, hw, c, c // 2)
            ptrs = [xp, *(kwargs[k] for k in ("w1", "w2", "scale1", "bias1", "scale2", "bias2",
                                               "inv_s1", "inv_s2", "s2", "s_x", "inv_out")), out]
            row = dict(kernel="resblock_int8 parts", B=b, stage=f"{hw}^2 C={c}",
                       plan={k: pl[k] for k in ("band_rows", "slices", "bn1", "bn2", "items")})
            for name, fn in launchers.items():
                def call(fn=fn):
                    err = fn(*(t.data_ptr() for t in ptrs), b, hw, hw, c, c // 2,
                             pl["band_rows"], pl["slice_cols"], pl["bn1"], pl["bn2"], 0, 0,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"k4parts: {name} failed with cudaError_t {err}")

                row[f"{name} device_us"] = device_us(call)
            print(json.dumps(row), flush=True)
            del x, xp, out
    if "k2threads" in picked:
        launch = resblock.build.function("round_sweep", "round_sweep_launch")
        for b, n in ((16, 10647), (1, 10647), (16, 22743)):
            boxes, scores = k2_case(b, n)
            pl = round_sweep.plan(b, n)
            sel = torch.empty((b, 100), dtype=torch.int32, device="cuda")
            nv = torch.empty((b,), dtype=torch.int32, device="cuda")
            want = round_sweep.round_sweep_ref(boxes, scores, IOU_THR, K2_SCORE_THR, 100)
            row = dict(kernel="round_sweep threads", B=b, N=n, plan=pl)
            for threads in (64, 128, 192, 256, 352, 448, 512, 672, 1024):
                def call(threads=threads):
                    err = launch(boxes.data_ptr(), scores.data_ptr(), sel.data_ptr(),
                                 nv.data_ptr(), b, n, 100, pl["cluster"], pl["share"], threads,
                                 IOU_THR, K2_SCORE_THR, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"k2threads: {threads} failed with cudaError_t {err}")

                call()
                torch.cuda.synchronize()
                if not (torch.equal(sel, want[0]) and torch.equal(nv, want[1])):
                    raise AssertionError(f"k2threads: {threads} threads differ from the plain "
                                         "version")
                row[f"{threads} device_us"] = device_us(call)
            print(json.dumps(row), flush=True)
    if "nms" in picked:
        boxes, conf, probs = exact_nms_case()
        times, same = escalation_times(nms, boxes, conf, probs)
        print(json.dumps(dict(what="yolo_nms_exact", B=boxes.shape[0], N=boxes.shape[1],
                              same_answer=same, **times)), flush=True)
        real_max = nms._MATRIX_SWEEP_MAX_K
        try:
            for b in (16, 4, 1):
                sub = [t[:b] for t in (boxes, conf, probs)]
                for k in (256, 512, 1024):
                    row = dict(what="yolo_nms top-K", B=b, K=k)
                    answers = []
                    for path, bound in (("matrix", 10 ** 9), ("round", k - 1)):
                        nms._MATRIX_SWEEP_MAX_K = bound

                        def call():
                            return nms.yolo_nms(*sub, max_boxes=100, iou_threshold=IOU_THR,
                                                score_threshold=K2_SCORE_THR, num_candidates=k)

                        with torch.inference_mode():
                            row[f"{path}_ms"] = cuda_ms(call, 5)
                            row[f"{path}_device_us"] = device_us(call, 5)
                            answers.append(call()[3:])
                    row["same_answer"] = all(torch.equal(a, b_) for a, b_ in zip(*answers))
                    print(json.dumps(row), flush=True)
                    torch.cuda.empty_cache()
        finally:
            nms._MATRIX_SWEEP_MAX_K = real_max
    for name, m, cin, cout, _ in K3_SHAPES if "k3" in picked else ():
        x, w, scale, bias, inv = conv1x1_case(m, cin, cout)
        for out_dtype in (torch.int8, torch.float32):
            def call():
                return conv1x1.conv1x1_int8_requant(x, w, scale, bias, inv, leaky=True,
                                                    out_dtype=out_dtype)

            print(json.dumps(dict(kernel="conv1x1_int8", shape=name, out=str(out_dtype)[6:],
                                  ms=cuda_ms(call, 50), device_us=device_us(call))), flush=True)
    for name, batch, hw, cin, cout, k, stride, pad in K6_SHAPES if "k6" in picked else ():
        x, kq, scale, bias, inv = conv_case(batch, hw, cin, cout, k)
        ms = cuda_ms(lambda: conv_int8.conv_int8(x, kq, scale, bias, inv, stride=stride,
                                                 padding=pad, leaky=True), 50)
        print(json.dumps(dict(kernel="conv_int8", shape=name, ms=ms)), flush=True)
    for shape in K5_SHAPES if "k5" in picked else ():
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(shape[1])
            x = (torch.randn(shape, generator=gen, device="cuda") * 2.0).to(dtype)
            dmean, dvar = torch.randn(shape[1], device="cuda"), torch.randn(shape[1], device="cuda")
            mean = bn_stats.bn_sums(x)[0] / (x.numel() // shape[1])
            with torch.no_grad():
                fwd = cuda_ms(lambda: bn_stats.bn_moments(x), 50)
            bwd = cuda_ms(lambda: bn_stats.bn_moments_dx(x, mean, dmean, dvar), 50)
            print(json.dumps(dict(kernel="bn_stats", shape=list(shape),
                                  dtype=str(dtype).split(".")[-1], memory="nchw",
                                  bn_moments_ms=fwd, bn_moments_dx_ms=bwd)), flush=True)
            del x
    for model, batch, tails in K7_TAILS if "k7" in picked else ():
        k7_times(model, batch, tails)
    for model, batch, tails in K8_TAILS if "k8" in picked else ():
        k8_times(model, batch, tails)
    return 0


def k7_times(model, batch, tails):
    """K7 at each of a model's BatchNorm tails (see the module's docstring),
    one JSON line a shape and layout, then one for the model's sums."""
    from yolov3_tpu_torch.ops.cuda import bn_leaky

    eps, slope = 1e-3, 0.1
    totals = {}
    for (c, hw), count in tails.items():
        for fmt in (torch.channels_last, torch.contiguous_format):
            gen = torch.Generator(device="cuda").manual_seed(c + hw)
            shape = (batch, c, hw, hw)
            x = (torch.randn(shape, generator=gen, device="cuda") * 2.0).to(
                torch.bfloat16).contiguous(memory_format=fmt)
            dy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16).contiguous(
                memory_format=fmt)
            mean = x.float().mean(dim=(0, 2, 3))
            var = x.float().var(dim=(0, 2, 3), unbiased=False)
            gamma = (torch.rand(c, generator=gen, device="cuda") * 0.4 + 0.8).to(torch.bfloat16)
            beta = (torch.rand(c, generator=gen, device="cuda") * 0.4 - 0.2).to(torch.bfloat16)
            args = (mean, var, gamma, beta, eps, slope)
            leaves = [t.detach().clone().requires_grad_(True) for t in (x, *args[:4])]

            def plain_backward():
                y = bn_leaky.bn_leaky_plain(*leaves, eps, slope)
                torch.autograd.grad(y, leaves, dy)

            with torch.no_grad():
                fwd = cuda_ms(lambda: bn_leaky.bn_leaky(x, *args), 20)
                fwd_us = device_us(lambda: bn_leaky.bn_leaky(x, *args))
                plain_fwd = cuda_ms(lambda: bn_leaky.bn_leaky_plain(x, *args), 10)
            bwd = cuda_ms(lambda: bn_leaky.bn_leaky_dx(x, dy, *args), 20)
            bwd_us = device_us(lambda: bn_leaky.bn_leaky_dx(x, dy, *args))
            plain_bwd = cuda_ms(plain_backward, 10)
            nbytes = x.numel() * x.element_size()
            row = dict(fwd_ms=fwd, fwd_device_us=fwd_us, fwd_bound_ms=2 * nbytes / HBM_BYTES_PER_S
                       * 1e3, bwd_ms=bwd, bwd_device_us=bwd_us,
                       bwd_bound_ms=3 * nbytes / HBM_BYTES_PER_S * 1e3, plain_fwd_ms=plain_fwd,
                       plain_fwd_bwd_ms=plain_bwd)
            layout = "channels_last" if fmt == torch.channels_last else "nchw"
            print(json.dumps(dict(kernel="bn_leaky", model=model, shape=list(shape),
                                  dtype="bfloat16", memory=layout, tails=count, **row)),
                  flush=True)
            total = totals.setdefault(layout, dict.fromkeys(row, 0.0))
            for k, v in row.items():
                total[k] += count * (v or 0.0)
            del x, dy, leaves
    for layout, t in totals.items():
        print(json.dumps(dict(kernel="bn_leaky", model=model, batch=batch, memory=layout,
                              tails=sum(tails.values()), sums=t,
                              fwd_share_of_bound=t["fwd_bound_ms"] * 1e3 / t["fwd_device_us"],
                              bwd_share_of_bound=t["bwd_bound_ms"] * 1e3 / t["bwd_device_us"])),
              flush=True)


def k8_times(model, batch, tails):
    """K8 at each of a model's fp tails (see the module's docstring), one JSON
    line a shape and layout, then one for the model's sums."""
    from yolov3_tpu_torch.ops.cuda import bias_act

    totals = {}
    for (activation, c, hw), count in tails.items():
        for fmt in (torch.channels_last, torch.contiguous_format):
            gen = torch.Generator(device="cuda").manual_seed(c + hw)
            shape = (batch, c, hw, hw)
            x = (torch.randn(shape, generator=gen, device="cuda") * 2.0).to(
                torch.bfloat16).contiguous(memory_format=fmt)
            bias = (torch.rand(c, generator=gen, device="cuda") * 2.0 - 1.0).to(torch.bfloat16)
            with torch.no_grad():
                y = bias_act.bias_act(x, bias, activation)
                equal = torch.equal(y.view(torch.int16), bias_act.bias_act_plain(
                    x, bias, activation).view(torch.int16))
                del y
                ms = cuda_ms(lambda: bias_act.bias_act(x, bias, activation), 20)
                us = device_us(lambda: bias_act.bias_act(x, bias, activation))
                plain_ms = cuda_ms(lambda: bias_act.bias_act_plain(x, bias, activation), 10)
            nbytes = 2 * x.numel() * x.element_size() + bias.numel() * bias.element_size()
            row = dict(ms=ms, device_us=us, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       plain_ms=plain_ms)
            layout = "channels_last" if fmt == torch.channels_last else "nchw"
            print(json.dumps(dict(kernel="bias_act", model=model, activation=activation,
                                  shape=list(shape), dtype="bfloat16", memory=layout,
                                  tails=count, equal=equal, **row,
                                  share_of_bound=row["bound_ms"] * 1e3 / us if us else None)),
                  flush=True)
            total = totals.setdefault(layout, dict.fromkeys(row, 0.0))
            for k, v in row.items():
                total[k] += count * (v or 0.0)
            del x
    for layout, t in totals.items():
        print(json.dumps(dict(kernel="bias_act", model=model, batch=batch, memory=layout,
                              tails=sum(tails.values()), sums=t,
                              share_of_bound=t["bound_ms"] * 1e3 / t["device_us"])), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
