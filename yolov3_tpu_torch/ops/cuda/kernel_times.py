"""Time K1 (``nms_sweep``), K3 (``conv1x1_int8``), K5 (``bn_stats``) and K6
(``conv_int8``) alone on the card, at the shapes ``chip_smoke.py`` holds them at.

    PYTHONPATH=. python3 yolov3_tpu_torch/ops/cuda/kernel_times.py [k1] [k3] [k5] [k6]
    PYTHONPATH=<other checkout> python3 yolov3_tpu_torch/ops/cuda/kernel_times.py k1 k3

The script imports the ``yolov3_tpu_torch`` that ``PYTHONPATH`` names and uses
only the wrappers' public functions, so the second form times another
checkout's kernels (say the parent commit's, unpacked with ``git archive``)
on the same card in the same run: run the two in turns to compare them.
The arguments pick kernels (all four without any). One JSON line a shape:
``ms``, the mean milliseconds of a call over a loop between two CUDA events
(the larger of the host's cost of a call and the device's), and for K1 and
K3 ``device_us``, the device microseconds of one call from torch.profiler
(the median over 20 calls in a row of each kernel the call launches, summed).
Needs a card; nothing here runs on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

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
# (B, K) of K1: the serving bucket K=512 at B=16 (the main path), 1 and 4, and
# the matrix-sweep bound K=4096
K1_CASES = ((16, 512), (1, 512), (4, 512), (16, 4096))
IOU_THR = 0.5
# (B, C, H, W) BatchNorm inputs of YOLOv3-416 at B=16, and one odd shape
K5_SHAPES = ((16, 32, 416, 416), (16, 64, 208, 208), (16, 256, 52, 52), (16, 512, 26, 26),
             (16, 1024, 13, 13), (3, 32, 5, 7))


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


def device_us(fn, calls=20):
    """Device µs of one call of ``fn``: torch.profiler over ``calls`` calls in a
    row, the median duration of each kernel they launch, summed. The window
    opens with 1,000 ``torch.cuda._sleep`` launches it ignores: the profiler
    on the H100 machine drops a window's first device records."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(1000):
            torch.cuda._sleep(64)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if (getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.name):
            by_name.setdefault(e.name, []).append(
                getattr(e, "device_time", 0) or getattr(e, "cuda_time", 0) or 0)
    return sum(float(np.median(v)) for v in by_name.values()) if by_name else None


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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card visible", file=sys.stderr)
        return 2
    import yolov3_tpu_torch
    from yolov3_tpu_torch.ops.cuda import bn_stats, conv1x1, conv_int8, nms_kernel

    picked = set(argv) or {"k1", "k3", "k5", "k6"}

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
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
