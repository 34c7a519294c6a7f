"""Observability of the trainer: step timing, spans and profiler traces.

Counterpart of ``yolov3_tpu/utils/profiling.py``:
  * ``StepTimer`` — wall-clock per-step stats (p50/p95/mean) and images/sec,
    a framework-neutral copy of the original (tests/test_torch_tb.py pins
    it);
  * ``trace(dir)`` — ``torch.profiler`` over the block (host ops, and the
    card's kernels when a card is visible), written on exit as a Chrome
    trace ``trace.<pid>.<ns>.json`` under ``dir``, which TensorBoard's
    profiler plugin and chrome://tracing read. No-op if ``dir`` is falsy.

The port's own additions:
  * ``span(name)`` — a named phase of the program. While a profiler runs it
    enters a ``record_function`` range (on the profiler's clock, beside the
    device trace); always it appends one ``SpanRecord`` (name, parent span,
    host-clock start and end in ``perf_counter_ns``, whether a profiler was
    running) to a buffer of the last ``SPAN_CAPACITY`` records, which
    ``span_records()`` returns. The train step's phases are spans
    (``parallel/train_step.py``: ``S|step`` around a step, ``S|anchors``,
    ``S|augment``, ``S|assign``, ``S|forward``, ``S|loss``, ``S|backward``,
    ``S|allreduce``, ``S|optimizer`` inside it; ``S|eval`` around an eval
    step), read by ``phase_summary``;
  * ``profiler_range(name)`` — the profiler half alone, recording nothing on
    the host: ``models/network.py``'s layer ranges ``L|…``. With no profiler
    running it is the shared null context ``NO_RANGE``, so a forward runs
    the same ops as without it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import statistics
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function


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
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace.{os.getpid()}.{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

SPAN_CAPACITY = 65_536
NO_RANGE = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    """One finished span: ``id`` in the order spans were entered, ``parent``
    the id of the span open around it on its thread (None at the top),
    ``start_ns`` / ``end_ns`` on ``time.perf_counter_ns``, ``profiled``
    whether a profiler was running when it was entered."""

    id: int
    name: str
    parent: int | None
    start_ns: int
    end_ns: int
    profiled: bool


_records: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_ids = itertools.count()
_open = threading.local()


def profiler_range(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs, else
    ``NO_RANGE``; records nothing on the host."""
    return record_function(name) if torch.autograd._profiler_enabled() else NO_RANGE


class span:
    """``with span(name):`` — a profiler range while a profiler runs, and
    always one ``SpanRecord`` on the host clock (see the module's doc)."""

    __slots__ = ("name", "_id", "_parent", "_range", "_stack", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self._stack = stack
        self._parent = stack[-1] if stack else None
        self._id = next(_ids)
        stack.append(self._id)
        self._range = profiler_range(self.name)
        self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        self._stack.pop()
        _records.append(SpanRecord(self._id, self.name, self._parent, self._start, end,
                                   self._range is not NO_RANGE))
        return False


def span_records() -> tuple:
    """The buffered ``SpanRecord``s, oldest first (in the order they ended)."""
    return tuple(_records)


def step_phases(records, root: str = "S|step") -> list[dict]:
    """One dict a ``root`` span of ``records`` that ran with no profiler:
    ``{root: host ns, phase name: host ns summed over the root's descendant
    spans of that name}``, in the roots' order."""
    by_id = {r.id: r for r in records}
    roots = {r.id: {root: r.end_ns - r.start_ns} for r in records
             if r.name == root and not r.profiled}
    for r in records:
        node = r
        while node.parent is not None and node.parent in by_id:
            node = by_id[node.parent]
            if node.id in roots:
                phases = roots[node.id]
                phases[r.name] = phases.get(r.name, 0) + (r.end_ns - r.start_ns)
                break
    return [roots[i] for i in sorted(roots)]


def phase_summary(records, root: str = "S|step") -> dict:
    """``{"steps": roots, root: median host ms, phase: median host ms a
    root}`` over ``step_phases``, phases in the order they end; a phase a
    root lacks counts 0 there."""
    steps = step_phases(records, root)
    if not steps:
        return {}
    names = list(dict.fromkeys(n for s in steps for n in s))
    return {"steps": len(steps),
            **{n: round(statistics.median(s.get(n, 0) for s in steps) / 1e6, 3)
               for n in names}}
