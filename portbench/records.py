"""What one run hands its per-layer readers (``metrics/<name>.py``).

``spans``: the benchmark's own host spans of the untraced window, {name:
[seconds]} (``predict``: a ``predict`` call until it returns, which is its
enqueue; ``step``: a train step's call until it returns). ``window``: the
untraced window's seconds, images and batches or steps. ``trace``: the
traced stretch (``trace.Trace``), or None in an untraced run. ``cell``,
``config``: the run's data files; ``table``: one image's layer
shapes and MACs (``flops.layer_table``); ``batch``: images a batch or step.
A reader returns a number, or None where it finds nothing to read; it never
returns 0 for a share of a roofline or of a peak.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import statistics

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Records:
    cell: dict
    config: dict
    table: dict
    batch: int
    spans: dict
    window: dict
    trace: object = None


def median_ms(rec: Records, span: str):
    values = rec.spans.get(span)
    return statistics.median(values) * 1e3 if values else None


def idle_pct(rec: Records):
    if rec.trace is None or rec.trace.window_us() <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_us() / rec.trace.window_us())


def mfu_pct(rec: Records, passes: float, peak: float):
    """``passes`` forwards' FLOPs an image × images over the untraced
    window's wall time, over ``peak``."""
    w = rec.window
    if not w.get("images") or not w.get("seconds"):
        return None
    flops = 2.0 * sum(e["macs"] for e in rec.table.values())
    return 100.0 * passes * flops * w["images"] / w["seconds"] / peak


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
