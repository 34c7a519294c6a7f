"""The train step's phases, read from the spans the port keeps.

The port (``yolov3_tpu_torch/utils/profiling.py::span``) runs each train
step inside ``S|step`` and its phases inside ``S|anchors``, ``S|assign``,
``S|forward``, ``S|loss``, ``S|backward``, ``S|optimizer`` (and
``S|augment``, ``S|allreduce`` where they run). A span is a ``record_function`` range
while a profiler runs, and always a host-clock record in the program's
buffer (``span_records()``: ``id``, ``name``, ``parent`` id, ``start_ns``,
``end_ns``, ``profiled``). Two readings, grouped here and not by the
program's own summary, so the yardstick does not move with the program:

  * ``phase_ms``: from the host records, the median over the steps that
    ran with no profiler (the untraced window, the checked steps around it)
    of a phase's host time summed within the step (a phase repeats under
    gradient accumulation);
  * ``step_launches``: from the traced stretch's host events
    (``trace.Trace.host``), the kernel launch calls that start inside an
    ``S|step`` range, on any thread (the autograd engine's thread launches
    the backward while the step waits in ``S|backward``), a step.

Both are None where there is nothing to read: a program that keeps no
spans, a run with no trace.
"""

from __future__ import annotations

import bisect
import re
import statistics

ROOT = "S|step"
LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx", "cudaGraphLaunch"))
_VERSION = re.compile(r"_v\d+$")


def records():
    """The program's span records, or () where the program keeps none."""
    try:
        from yolov3_tpu_torch.utils.profiling import span_records
    except ImportError:
        return ()
    return span_records()


def phase_ms(spans, phases):
    """Median host ms a step of the ``phases``' spans summed within each
    unprofiled ``S|step`` of ``spans``; None without such a step or where no
    step holds one of the phases."""
    by_id = {r.id: r for r in spans}
    roots = {r.id: 0 for r in spans if r.name == ROOT and not r.profiled}
    seen = False
    for r in spans:
        if r.name not in phases:
            continue
        node = r
        while node.parent is not None and node.parent in by_id:
            node = by_id[node.parent]
            if node.id in roots:
                roots[node.id] += r.end_ns - r.start_ns
                seen = True
                break
    if not roots or not seen:
        return None
    return statistics.median(roots.values()) / 1e6


def is_launch(name: str) -> bool:
    return _VERSION.sub("", name) in LAUNCH_CALLS


def step_launches(trace):
    """Kernel launch calls a step in the traced stretch; None without a
    trace or an ``S|step`` range in it."""
    if trace is None:
        return None
    steps = sorted((start, end) for start, end, _, name in trace.host if name == ROOT)
    if not steps:
        return None
    starts = [s for s, _ in steps]
    count = 0
    for start, _, _, name in trace.host:
        if is_launch(name):
            i = bisect.bisect_right(starts, start) - 1
            if i >= 0 and start <= steps[i][1]:
                count += 1
    return count / len(steps)
