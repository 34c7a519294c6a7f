"""Train-step profiler: host-clock img/s, device ms per step, device time by
kernel, peak device memory.

Counterpart of the JAX package's ``tools/profile_train.py``, with its flags
plus ``--device``:

    python -m yolov3_tpu_torch.tools.profile_train [--batch 128] [--image_size 416]
        [--nclasses 80] [--steps 10] [--fp32] [--bn_subsample N] [--s2d]
        [--trace] [--top 15] [--top_fusions N] [--device cpu]

The step is the port's ``make_train_step`` (Adam 1e-3, bf16 unless
``--fp32``) on the model's Keras-default weights from
``torch.Generator().manual_seed(0)``, one batch of ``RandomState(0)`` images
and the JAX tool's three boxes per image. ``wall`` is the host clock over
``--steps`` steps ending in a synchronize (the host's launches included);
``phases`` the median host ms a step of the step's spans (``S|step`` and
its phases, ``utils/profiling.py::phase_summary``) over those steps, and
``bn tails`` how many training BatchNorm tails a step ran through K7
(``ops/cuda/bn_leaky.py``), why the others did not, and how many of K7's
backward launches a step had their gradient copied to x's memory format.
``--trace`` profiles two more steps (``ops/cuda/kernel_times.profile_window``)
and prints the device-busy ms per step, the kernel launch calls a step by
the phase span they were made in (on any thread: the autograd engine's
thread launches the backward while the step waits in ``S|backward``) and
the device time by kernel name (``--top`` of them, with their launches);
``--top_fusions N`` adds the N ops whose kernels took the most device
time. ``--dump_hlo`` has no meaning here (no XLA program) and raises. The
JAX default batch, 128, is kept; a batch the card cannot hold raises
torch's out-of-memory error.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda.bn_leaky import bn_leaky, bn_leaky_dx
from ..utils.profiling import phase_summary, span_records
from . import _measure as M

# the CUDA runtime and `cu` API calls that launch a kernel or a graph
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch")


def train_inputs(batch: int, image_size: int, device):
    """The JAX tool's batch: ``RandomState(0)`` images and three boxes an image."""
    rng = np.random.RandomState(0)
    images = rng.rand(batch, image_size, image_size, 3).astype(np.float32)
    labels = np.zeros((batch, 20, 6), np.float32)
    labels[:, :3] = [[0.3, 0.3, 0.6, 0.6, 1, 1], [0.1, 0.5, 0.3, 0.9, 1, 3],
                     [0.6, 0.1, 0.9, 0.4, 1, 7]]
    return torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)


def build_step(spec, params, state, batch: int, image_size: int, device, fp32: bool = False,
               bn_subsample: int = 1, s2d: bool = False):
    """The profiled step → ``(step, train_state)``: Adam 1e-3, the seeded
    anchors, ``compute_dtype`` bf16 unless ``fp32``, the space-to-depth stem
    reschedule with ``s2d``, BatchNorm statistics from a ``bn_subsample``
    subsample."""
    from ..models.network import head_grid_sizes, to_device
    from ..ops.s2d import s2d_stem_train
    from ..parallel.train_step import init_train_state, make_adam, make_train_step

    grid_sizes = head_grid_sizes(spec, image_size)
    anchors = M.seeded_anchors(len(grid_sizes))
    opt = make_adam(1e-3)
    step_spec = s2d_stem_train(spec, image_size) if s2d else spec
    if step_spec is not spec:
        print("stem_s2d: on", file=sys.stderr)
    if bn_subsample > 1:
        print(f"bn_stats_subsample: {bn_subsample}", file=sys.stderr)
    step = make_train_step(step_spec, anchors, grid_sizes, batch_size=batch, optimizer=opt,
                           compute_dtype=None if fp32 else torch.bfloat16,
                           bn_stats_subsample=bn_subsample)
    return step, init_train_state(to_device(params, device), to_device(state, device), opt)


def by_kernel(records):
    """Device µs and launches by kernel name of ``profile_window`` records."""
    us, count = collections.Counter(), collections.Counter()
    for _, name, dur in records:
        us[name] += dur
        count[name] += 1
    return us, count


def by_op(events):
    """Device µs of the kernels each op launched, by op name (profiler events)."""
    from .mfu_table import is_kernel

    us = collections.Counter()
    for ev in events:
        for k in getattr(ev, "kernels", ()):
            if is_kernel(k.name):
                us[ev.name] += k.duration
    return us


def launches_by_phase(events, steps: int):
    """Kernel launch calls a step by the innermost ``S|…`` span around each
    (by time, on any thread), of those made inside an ``S|step`` range of the
    profiler ``events`` (their host side: a range's span on the device's
    timeline is left out); a launch in the step outside its phases counts
    under ``S|step``."""
    host = [e for e in events
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in host
                    if e.name.startswith("S|"))
    out = collections.Counter()
    for e in host:
        if e.name.split("_v")[0] not in LAUNCH_CALLS:
            continue
        t = e.time_range.start
        around = [(end - start, name) for start, end, name in ranges if start <= t <= end]
        if any(name == "S|step" for _, name in around):
            out[min(around)[1]] += 1
    return {name: n / steps for name, n in out.most_common()}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.profile_train")
    ap.add_argument("--model_config_file", default="config/models/yolov3/model.yaml")
    ap.add_argument("--nclasses", type=int, default=80)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image_size", type=int, default=416)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--fp32", action="store_true", help="float32 compute (no bf16)")
    ap.add_argument("--bn_subsample", type=int, default=1,
                    help="BN stats from a strided spatial subsample")
    ap.add_argument("--s2d", action="store_true",
                    help="the space-to-depth stem reschedule (ops/s2d.py::s2d_stem_train)")
    ap.add_argument("--trace", action="store_true",
                    help="profile two steps: device ms a step and device time by kernel")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--top_fusions", type=int, default=0,
                    help="also print the N ops whose kernels took the most device time")
    ap.add_argument("--dump_hlo", default="", help="JAX only: raises here")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.dump_hlo:
        raise ValueError("--dump_hlo: the PyTorch step is eager and has no XLA program to "
                         "dump; use --trace (device time by kernel) and --top_fusions")
    from ..models import init_model, parse_model_config

    dev = resolve_device(args.device)
    spec = parse_model_config(M.repo_path(args.model_config_file), args.nclasses)
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    b = args.batch
    step, ts = build_step(spec, params, state, b, args.image_size, dev, args.fp32,
                          args.bn_subsample, args.s2d)
    images, labels = train_inputs(b, args.image_size, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ts, m = step(ts, images, labels)
    print(f"warm loss {float(m['total_loss']):.3f}", file=sys.stderr)

    spans_from = time.perf_counter_ns()
    bn_leaky.tails.clear()
    dy_copies = bn_leaky_dx.dy_copies
    t0 = time.perf_counter()
    losses = []
    for _ in range(args.steps):
        ts, m = step(ts, images, labels)
        losses.append(m["total_loss"])
    total = float(m["total_loss"])  # the fetch synchronizes
    dt = (time.perf_counter() - t0) / args.steps
    phases = phase_summary([r for r in span_records() if r.start_ns >= spans_from])
    if not np.isfinite(total):
        raise AssertionError(f"profile_train: non-finite loss {total}")
    device = M.device_record(dev)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    print(f"wall: {dt * 1e3:.1f} ms/step  {b / dt:.1f} img/s (host clock, the host's "
          f"launches included); peak memory: "
          + ("not measured" if peak_gb is None else f"{peak_gb:.2f} GB (max_memory_allocated)")
          + f"; device: {M.device_text(device)}", flush=True)
    print(f"phases (host ms, median a step): {phases}", flush=True)
    tails = {route: n / args.steps for route, n in bn_leaky.tails.most_common()}
    others = {route: n for route, n in tails.items() if route != "fused"}
    copies = (bn_leaky_dx.dy_copies - dy_copies) / args.steps
    print(f"bn tails fused {tails.get('fused', 0):g} of {sum(tails.values()):g} a step"
          + (f" (fell back: {others})" if others else "")
          + (f"; {copies:g} gradients a step copied to the tail's layout" if copies else ""),
          flush=True)
    result = dict(batch=b, image_size=args.image_size, fp32=args.fp32, wall_ms=dt * 1e3,
                  img_per_sec=b / dt, peak_gb=peak_gb, loss=total,
                  losses=[float(x) for x in losses], phases=phases, bn_tails=tails,
                  device=device)
    if not args.trace:
        return result
    if dev.type != "cuda":
        print("(--trace: no device trace on the CPU)")
        return result
    from ..ops.cuda import kernel_times

    def two_steps():
        nonlocal ts
        for _ in range(2):
            ts, _ = step(ts, images, labels)

    prof, _, records = kernel_times.profile_window(two_steps)
    if not records:
        raise RuntimeError("profile_train: the profiler trace holds no device record")
    busy_ms = sum(us for _, _, us in records) / 1e3 / 2
    print(f"device: {busy_ms:.2f} ms/step ({b / (busy_ms / 1e3):.1f} img/s device rate; "
          "device-busy from the profiler)")
    launches = launches_by_phase(prof.events(), 2)
    print(f"-- kernel launch calls a step by phase ({sum(launches.values()):.0f} in all): "
          f"{launches}")
    us, count = by_kernel(records)
    print("-- device time by kernel name (ms/step):")
    for name, v in us.most_common(args.top):
        print(f"   {name[:60]:60s} {v / 2 / 1e3:7.2f}  x{count[name]}")
    if args.top_fusions:
        print(f"-- top {args.top_fusions} ops by their kernels' device time (ms/step):")
        for name, v in by_op(prof.events()).most_common(args.top_fusions):
            print(f"   {name[:60]:60s} {v / 2 / 1e3:7.2f}")
    return dict(result, device_busy_ms=busy_ms, launches_per_step=len(records) / 2,
                launch_calls_by_phase=launches,
                top_kernels={n: v / 2 / 1e3 for n, v in us.most_common(args.top)})


if __name__ == "__main__":
    main()
