"""Observability of the trainer: step timing and profiler traces.

Counterpart of ``yolov3_tpu/utils/profiling.py``:
  * ``StepTimer`` — wall-clock per-step stats (p50/p95/mean) and images/sec,
    a framework-neutral copy of the original (tests/test_torch_tb.py pins
    it);
  * ``trace(dir)`` — ``torch.profiler`` over the block (host ops, and the
    card's kernels when a card is visible), written on exit as a Chrome
    trace ``trace.<pid>.<ns>.json`` under ``dir``, which TensorBoard's
    profiler plugin and chrome://tracing read. No-op if ``dir`` is falsy.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


class StepTimer:
    def __init__(self, images_per_step: int = 0):
        self.images_per_step = images_per_step
        self.durations: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.durations.append(time.perf_counter() - self._t0)
        return False

    def stats(self) -> dict:
        if not self.durations:
            return {}
        d = np.asarray(self.durations)
        out = {
            "steps": len(d),
            "mean_ms": float(d.mean() * 1000),
            "p50_ms": float(np.percentile(d, 50) * 1000),
            "p95_ms": float(np.percentile(d, 95) * 1000),
        }
        if self.images_per_step:
            out["images_per_sec"] = float(self.images_per_step / d.mean())
        return out


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """``torch.profiler`` trace of the block into ``trace_dir``; yields the
    path the trace is written to on exit (None when ``trace_dir`` is falsy)."""
    if not trace_dir:
        yield None
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace.{os.getpid()}.{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
