"""Time K5 (``bn_stats``) and K6 (``conv_int8``) alone on the card, at the
shapes ``chip_smoke.py`` holds them at.

    PYTHONPATH=. python3 yolov3_tpu_torch/ops/cuda/kernel_times.py
    PYTHONPATH=<other checkout> python3 yolov3_tpu_torch/ops/cuda/kernel_times.py

The script imports the ``yolov3_tpu_torch`` that ``PYTHONPATH`` names and uses
only the wrappers' public functions, so the second form times another
checkout's kernels (say the parent commit's, unpacked with ``git archive``)
on the same card in the same run: run the two in turns to compare them.
One JSON line a shape: mean milliseconds of a call over a loop between two
CUDA events (which is the larger of the host's cost of a call and the
device's). Needs a card; nothing here runs on the CPU.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card visible", file=sys.stderr)
        return 2
    import yolov3_tpu_torch
    from yolov3_tpu_torch.ops.cuda import bn_stats, conv_int8

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(dict(card=card, package=os.path.dirname(yolov3_tpu_torch.__file__))),
          flush=True)
    for name, batch, hw, cin, cout, k, stride, pad in K6_SHAPES:
        x, kq, scale, bias, inv = conv_case(batch, hw, cin, cout, k)
        ms = cuda_ms(lambda: conv_int8.conv_int8(x, kq, scale, bias, inv, stride=stride,
                                                 padding=pad, leaky=True), 50)
        print(json.dumps(dict(kernel="conv_int8", shape=name, ms=ms)), flush=True)
    for shape in K5_SHAPES:
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
    sys.exit(main())
