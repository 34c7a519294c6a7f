"""A/B of one Darknet residual block (1×1 squeeze → 3×3 expand → shortcut,
int8 chain semantics) at the production stage shapes: the fused block (K4,
``ops/cuda/resblock.py``) against the unfused chain ``layers.conv2d_int8``
(K3) → ``layers.conv2d_int8`` (K6) → ``layers.add_requant``.

Counterpart of the JAX package's ``tools/bench_resblock.py``, with its flags
plus ``--device``:

    python -m yolov3_tpu_torch.tools.bench_resblock [--stages 13,26] [--b 128]
        [--iters 50] [--device cpu]

Each stage's block: C = 1024 at 13², 512 at 26², 256 otherwise, Cm = C/2;
int8 input and weights and float32 scales and biases drawn by numpy's
``RandomState`` with the JAX tool's distributions and constants. Each path
chains ``--iters`` blocks, each block's input the previous one's output (the
output scale is not the input's: shape and dtype are all a throughput run
needs), timed by CUDA events around the chain after one warm-up chain, and
reported in ms a block and TOPS (2·B·H·W·(C·Cm + 9·Cm·C) a block). A path
that fails to build or launch raises. The fused path keeps the halo layout
between blocks, as ``fused_stage`` does.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from . import _measure as M

S_X, S_1, S_2, S_OUT = 0.0413, 0.0518, 0.0727, 0.0611


def stage_channels(hw: int) -> int:
    return 1024 if hw == 13 else (512 if hw == 26 else 256)


def block_inputs(b: int, hw: int, device, seed: int = 0):
    """The block's seeded tensors on ``device`` → (xq (B, H, W, C) int8, squeeze
    entry, expand entry, shortcut entry, s_x), entries in the port's chain-mode
    layout (``kernel_q`` (cout, kh, kw, cin))."""
    c = stage_channels(hw)
    cm = c // 2
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    xq = t(rng.randint(-127, 128, (b, hw, hw, c)).astype(np.int8))
    w1 = rng.randint(-127, 128, (cm, 1, 1, c)).astype(np.int8)
    w2 = rng.randint(-127, 128, (c, 3, 3, cm)).astype(np.int8)
    sc1 = rng.uniform(1e-4, 1e-3, cm).astype(np.float32)
    b1 = rng.randn(cm).astype(np.float32)
    sc2 = rng.uniform(1e-5, 1e-4, c).astype(np.float32)
    b2 = rng.randn(c).astype(np.float32)
    f32 = lambda v: t(np.float32(v))  # noqa: E731
    squeeze = dict(kernel_q=t(w1), w_scale=t(sc1), bias=t(b1), out_scale=f32(S_1))
    expand = dict(kernel_q=t(w2), w_scale=t(sc2), bias=t(b2), out_scale=f32(S_2))
    return xq, squeeze, expand, dict(out_scale=f32(S_OUT)), f32(S_X)


def unfused_block(xq, squeeze, expand, shortcut, s_x):
    """K3 → K6 → ``add_requant`` on ``xq`` at scale ``s_x`` → int8 (B, H, W, C)."""
    from ..models import layers as L

    x = L.QAct(xq, s_x)
    a = L.conv2d_int8(x, squeeze, 1, 1, leaky=True)
    a = L.conv2d_int8(a, expand, 1, 1, leaky=True)
    return L.add_requant(x, a, shortcut["out_scale"]).q


def chains(b: int, hw: int, iters: int, device):
    """The two chained paths of one stage → {"unfused": fn, "fused": fn}, each
    ``fn()`` running ``iters`` blocks and returning the final int8 tensor
    (the fused one in halo layout)."""
    from ..ops.cuda import resblock

    xq, squeeze, expand, shortcut, s_x = block_inputs(b, hw, device)
    kwargs, _ = resblock.block_args(squeeze, expand, shortcut, s_x)
    xp = resblock.to_halo(xq)

    def unfused():
        q = xq
        for _ in range(iters):
            q = unfused_block(q, squeeze, expand, shortcut, s_x)
        return q

    def fused():
        p = xp
        for _ in range(iters):
            p = resblock.fused_resblock(p, **kwargs, b=b, h=hw, w=hw)
        return p

    return {"unfused": unfused, "fused": fused}


def timed_ms(fn, device) -> float:
    """Milliseconds of ``fn()``: CUDA events on the card, the host clock
    ending in a synchronize on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.bench_resblock")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--stages", default="13,26")
    ap.add_argument("--bt", type=int, default=None,
                    help="JAX only (the Pallas kernel's batch tile); K4 plans its own tiles")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.bt is not None:
        raise ValueError("--bt: K4 takes no batch tile; its plan (ops/cuda/resblock.py::plan) "
                         "sets the tiles from the shape")
    dev = resolve_device(args.device)
    device = M.device_record(dev)
    rows = []
    with torch.inference_mode():
        for hw in (int(s) for s in args.stages.split(",")):
            c = stage_channels(hw)
            cm = c // 2
            ops = 2 * args.b * hw * hw * (c * cm + 9 * cm * c) * args.iters
            for name, fn in chains(args.b, hw, args.iters, dev).items():
                out = fn()  # build, warm-up
                M.sync(dev)
                ms = timed_ms(fn, dev)
                chk = int(out.to(torch.int32).abs().sum())
                row = dict(hw=hw, c=c, path=name, ms_per_block=ms / args.iters,
                           tops=ops / (ms / 1e3) / 1e12, checksum=chk)
                rows.append(row)
                print(f"{hw}x{hw} c={c}: {name:8s} {row['ms_per_block']:7.3f} ms/block  "
                      f"{row['tops']:6.1f} TOPS", flush=True)
    print(json.dumps({"device": device, "batch": args.b, "iters": args.iters}), flush=True)
    return dict(rows=rows, device=device)


if __name__ == "__main__":
    main()
