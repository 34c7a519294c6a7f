"""One module per traffic mode, found by the cell file's ``mode``:
``run(ctx)`` sets up, marks the set-up's end (``ctx.setup_done``), measures
for ``ctx.seconds``, profiles a stretch when ``ctx.trace``, reads the memory
peak, frees the program and leaves what the check reads in
``ctx.evidence``; ``check(ctx, evidence)`` → the check's numbers."""

from __future__ import annotations

import contextlib

import torch

_NONE = contextlib.nullcontext()


def span(name: str):
    """The benchmark's own host range ``portbench|<name>``, entered only while
    a profiler runs (the trace's attribution and idle gaps read it)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(f"portbench|{name}")
    return _NONE
