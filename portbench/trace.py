"""The device trace of a traced stretch, and what the per-layer readers take
from it.

``profile(run)`` runs ``run()`` once under ``torch.profiler`` between two
pads of ``torch.cuda._sleep`` launches (a thousand short ones, then one of
10–12 ms). The profiler on the H100 drops device records at a window's
edges; the pads take that loss, and a window whose own records are not
bracketed by pad records on both sides is opened again, up to three times
(the port's ``ops/cuda/kernel_times.profile_window``, copied here so the
yardstick does not move with the program). Pad records are left out of
everything read. The stretch's window is the device time between the last
record of the leading pad and the first of the trailing one.

A kernel is attributed through the profiler's correlation of each CPU op
with the kernels it launched: to the innermost layer range
``L|<sub-model>|<layer>|<kind>`` around the op (the port's
``models/network.py`` enters them under a profiler) and to the innermost
range of the benchmark's own (``portbench|<span>``). A range's own span on
the device timeline is not a kernel and is never counted.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import sys

import torch

PAD_LAUNCHES = 1000
PAD_SPIN_CYCLES = 20_000_000
PROFILER_WINDOWS = 3
PAD_KERNEL = "spin_kernel"
SPAN = "portbench|"


def _pad():
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(64)
    torch.cuda._sleep(PAD_SPIN_CYCLES)
    torch.cuda.synchronize()


def is_range_span(event) -> bool:
    return (bool(getattr(event, "is_user_annotation", False))
            or event.name.startswith(("L|", SPAN)))


def _device_us(event) -> float:
    return float(getattr(event, "device_time", 0) or getattr(event, "cuda_time", 0) or 0)


@dataclasses.dataclass
class Trace:
    """``kernels``: [(start µs, end µs, name)] in device order; ``window``:
    (start µs, end µs); ``attributed``: [(name, µs, layer range or None,
    benchmark span or None)]; ``host``: [(start µs, end µs, depth, name)] of
    the CPU ops and ranges; ``units``: batches or steps in the stretch."""

    kernels: list
    window: tuple
    attributed: list
    host: list
    units: int

    def busy_us(self) -> float:
        """Device time in which some kernel ran: the union of the kernels'
        intervals inside the window."""
        busy, end = 0.0, self.window[0]
        for start, stop, _ in sorted(self.kernels):
            start, stop = max(start, end), min(stop, self.window[1])
            if stop > start:
                busy += stop - start
                end = stop
        return busy

    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def gaps(self):
        """[(start µs, length µs)] of the device's idle stretches in the window."""
        out, end = [], self.window[0]
        for start, stop, _ in sorted(self.kernels):
            if start > end:
                out.append((end, start - end))
            end = max(end, stop)
        if self.window[1] > end:
            out.append((end, self.window[1] - end))
        return out

    def device_ops(self, top: int = 10):
        total = collections.Counter()
        for start, stop, name in self.kernels:
            total[name] += stop - start
        return [[name, us / 1e6] for name, us in total.most_common(top)]

    def idle_gaps(self, top: int = 10):
        """The device's idle time summed by what the host was doing when each
        gap began: the benchmark's open span and the innermost host op."""
        gaps = sorted(self.gaps())
        host = sorted(self.host)
        named, active, j = collections.Counter(), [], 0
        for start, length in gaps:
            while j < len(host) and host[j][0] <= start:
                heapq.heappush(active, (host[j][1], -host[j][2], host[j][3]))
                j += 1
            while active and active[0][0] < start:
                heapq.heappop(active)
            open_now = sorted(((-neg, name) for stop, neg, name in active if stop >= start))
            span = next((n for _, n in reversed(open_now) if n.startswith(SPAN)), "")
            inner = open_now[-1][1] if open_now else "(no host op)"
            named[f"{span[len(SPAN):] or '-'}/{inner}"] += length
        return [[name, us / 1e6] for name, us in named.most_common(top)]


def profile(run, units: int) -> Trace:
    """``run()`` under the profiler, padded (see the module's doc)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(PROFILER_WINDOWS):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _pad()
            run()
            torch.cuda.synchronize()
            _pad()
        events = prof.events()
        records = sorted(
            (e.time_range.start, e.time_range.start + _device_us(e), e.name) for e in events
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not is_range_span(e))
        pads = [r for r in records if PAD_KERNEL in r[2]]
        own = [r for r in records if PAD_KERNEL not in r[2]]
        if own and pads and pads[0][0] < own[0][0] and pads[-1][0] > own[-1][0]:
            break
        print(f"trace: {len(own)} records of the stretch, {len(pads)} of the pads, not "
              "bracketed; profiling again", file=sys.stderr, flush=True)
    if not own:
        raise RuntimeError("trace: the profiler recorded no kernel of the stretch")
    lead = max([r[1] for r in pads if r[0] < own[0][0]], default=own[0][0])
    trail = min([r[0] for r in pads if r[0] > own[-1][0]], default=max(r[1] for r in own))
    return Trace(own, (lead, trail), _attribute(events), _host(events), units)


def _scopes(event):
    layer = span = None
    node = event
    while node is not None:
        if layer is None and node.name.startswith("L|"):
            layer = node.name
        if span is None and node.name.startswith(SPAN):
            span = node.name[len(SPAN):]
        node = node.cpu_parent
    return layer, span


def _attribute(events):
    out = []
    for ev in events:
        kernels = [k for k in getattr(ev, "kernels", ()) if PAD_KERNEL not in k.name
                   and not k.name.startswith(("L|", SPAN))]
        if not kernels:
            continue
        layer, span = _scopes(ev)
        out.extend((k.name, float(k.duration), layer, span) for k in kernels)
    return out


def _host(events):
    out = []
    for ev in events:
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CPU:
            continue
        depth, node = 0, ev.cpu_parent
        while node is not None:
            depth, node = depth + 1, node.cpu_parent
        out.append((ev.time_range.start, ev.time_range.end, depth, ev.name))
    return out
