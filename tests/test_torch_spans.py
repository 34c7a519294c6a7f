"""The port's spans (yolov3_tpu_torch/utils/profiling.py::span) and the train
step's phases (parallel/train_step.py) on the CPU: YOLOv3-tiny at 96 px,
B=4, three classes, the port's own seeded init.

  * a span links to the span open around it on its thread, and its record
    holds the host clock's start and end and whether a profiler ran;
  * the buffer keeps its capacity, the oldest records dropped;
  * the ``record_function`` range is entered only under a profiler;
  * a step records ``S|step`` over anchors, assign, forward, loss, backward
    and optimizer once each, in that order; with ``accum_steps=2`` assign,
    forward, loss and backward twice under one root; ``S|augment`` with
    augmentation, ``S|allreduce`` under a process group, ``S|eval`` around
    an eval step;
  * a step's new state and metrics are the same bits with a profiler
    running, and the layer ranges keep their ``L|…`` names;
  * ``phase_summary`` and ``profile_train.launches_by_phase`` on synthetic
    records.

No wall-clock threshold: the suite runs beside other processes."""

import collections
import os
import types

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.models import init_model, parse_model_config
from yolov3_tpu_torch.models.network import head_grid_sizes
from yolov3_tpu_torch.parallel import mesh as tmesh
from yolov3_tpu_torch.parallel import train_step as tts
from yolov3_tpu_torch.tools import profile_train
from yolov3_tpu_torch.tree import tree_leaves
from yolov3_tpu_torch.utils import profiling
from yolov3_tpu_torch.utils.profiling import SpanRecord, span, span_records

from .conftest import REPO
from .test_torch_multihost import one_process_group
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

ANCHORS = np.array([[0.1, 0.1], [0.2, 0.2], [0.3, 0.3],
                    [0.4, 0.4], [0.5, 0.5], [0.6, 0.6]], np.float32).reshape(2, 3, 2)
SIZE, BATCH, NC = 96, 4, 3
PHASES = ["S|anchors", "S|assign", "S|forward", "S|loss", "S|backward", "S|optimizer"]


@pytest.fixture(scope="module")
def tiny():
    spec = parse_model_config(os.path.join(REPO, "config/models/yolov3_tiny/model.yaml"), NC)
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32))
    labels = np.zeros((BATCH, 10, 6), np.float32)
    for b in range(BATCH):
        for m in range(3):
            x0, y0 = rng.rand(2) * 0.6
            w, h = rng.rand(2) * 0.3 + 0.05
            labels[b, m] = [x0, y0, x0 + w, y0 + h, 1, rng.randint(NC)]
    return types.SimpleNamespace(spec=spec, params=params, state=state, images=images,
                                 labels=torch.from_numpy(labels),
                                 grids=head_grid_sizes(spec, SIZE))


def _records_of(fn):
    """``fn()``'s result and the span records that started while it ran."""
    since = profiling.time.perf_counter_ns()
    out = fn()
    return out, [r for r in span_records() if r.start_ns >= since]


def _children(records, root):
    return [r.name for r in sorted(records, key=lambda r: r.start_ns) if r.parent == root.id]


def _one_step(tiny, **kwargs):
    opt = tts.make_adam(1e-3)
    mesh = kwargs.pop("mesh", None)
    step = tts.make_train_step(tiny.spec, ANCHORS, tiny.grids, BATCH, opt, mesh=mesh, **kwargs)
    state = tts.init_train_state(tiny.params, tiny.state, opt)
    return _records_of(lambda: step(state, tiny.images, tiny.labels))


def test_spans_nest_and_link_their_parents():
    def nested():
        with span("a"):
            with span("b"):
                with span("c"):
                    pass
            with span("d"):
                pass

    _, recs = _records_of(nested)
    by = {r.name: r for r in recs}
    assert sorted(by) == ["a", "b", "c", "d"] and len(recs) == 4
    assert by["a"].parent is None
    assert by["b"].parent == by["d"].parent == by["a"].id and by["c"].parent == by["b"].id
    assert [r.name for r in recs] == ["c", "b", "d", "a"]  # in the order they ended
    a = by["a"]
    for r in recs:
        assert a.start_ns <= r.start_ns <= r.end_ns <= a.end_ns and not r.profiled
    assert by["b"].end_ns <= by["d"].start_ns
    assert isinstance(a, SpanRecord) and isinstance(span_records(), tuple)


def test_buffer_stays_at_its_capacity():
    cap = profiling.SPAN_CAPACITY
    _, ours = _records_of(lambda: [span("fill").__enter__().__exit__() for _ in range(cap + 10)])
    buffered = span_records()
    assert len(buffered) == cap
    # the oldest ten of ours were dropped, the newest is last
    assert len(ours) == cap and all(r.name == "fill" for r in ours)
    assert buffered[-1].id - buffered[0].id == cap - 1


def test_range_entered_only_under_a_profiler(monkeypatch):
    entered = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: (entered.append(name), real(name))[1])
    with span("S|probe"):
        pass
    assert entered == [] and span_records()[-1].profiled is False
    assert profiling.profiler_range("L|x") is profiling.NO_RANGE
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("S|probe"):
            torch.ones(2).sum()
    assert entered == ["S|probe"] and span_records()[-1].profiled is True
    assert [e.name for e in prof.events()].count("S|probe") == 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(2).sum()
    assert not any(e.name.startswith("S|") for e in prof.events())


def test_a_step_records_its_phases_once_each_in_order(tiny):
    _, recs = _one_step(tiny)
    roots = [r for r in recs if r.name == "S|step"]
    assert len(roots) == 1 and roots[0].parent is None
    assert _children(recs, roots[0]) == PHASES
    assert sorted(r.name for r in recs) == sorted(PHASES + ["S|step"])
    summary = profiling.phase_summary(recs)
    assert list(summary) == ["steps", "S|step"] + PHASES and summary["steps"] == 1


def test_accumulation_repeats_the_phases_under_one_root(tiny):
    _, recs = _one_step(tiny, accum_steps=2)
    roots = [r for r in recs if r.name == "S|step"]
    assert len(roots) == 1
    assert _children(recs, roots[0]) == ["S|anchors"] + PHASES[1:5] * 2 + ["S|optimizer"]


def test_augmentation_and_allreduce_have_their_spans(tiny, tmp_path):
    _, recs = _one_step(tiny, augment={"flip": True})
    root = next(r for r in recs if r.name == "S|step")
    assert _children(recs, root) == ["S|anchors", "S|augment"] + PHASES[1:]
    with one_process_group(tmp_path) as group:
        mesh = tmesh.Mesh((torch.device("cpu"),), group=group, rank=0, world_size=1)
        _, recs = _one_step(tiny, mesh=mesh)
    root = next(r for r in recs if r.name == "S|step")
    assert _children(recs, root) == PHASES[:5] + ["S|allreduce", "S|optimizer"]


def test_eval_step_runs_under_its_own_root(tiny):
    step = tts.make_eval_step(tiny.spec, ANCHORS, tiny.grids, BATCH)
    _, recs = _records_of(lambda: step(tiny.params, tiny.state, tiny.images, tiny.labels))
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["S|eval"]
    assert _children(recs, roots[0]) == PHASES[:4]
    assert profiling.phase_summary(recs) == {}


def test_profiled_step_is_bit_identical_and_keeps_the_layer_ranges(tiny):
    (plain, plain_m), _ = _one_step(tiny)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (traced, traced_m), recs = _one_step(tiny)
    for key in ("params", "bn_state", "opt_state"):
        a, b = tree_leaves(plain[key]), tree_leaves(traced[key])
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), key
    for k in plain_m:
        assert torch.equal(plain_m[k], traced_m[k]), k
    assert all(r.profiled for r in recs)
    names = [e.name for e in prof.events()]
    assert [n for n in names if n.startswith("S|")].count("S|step") == 1
    assert set(PHASES) <= set(names)
    layers = {n for n in names if n.startswith("L|")}
    assert layers == {f"L|{sm.name}|layer{i}|{layer.kind}"
                      for sm in tiny.spec.sub_models for i, layer in enumerate(sm.layers)}
    assert profiling.phase_summary(recs) == {}  # profiled steps are left out


def _rec(i, name, parent, start, end, profiled=False):
    return SpanRecord(i, name, parent, start * 10**6, end * 10**6, profiled)


def test_phase_summary_takes_medians_of_summed_phases_over_unprofiled_roots():
    recs = [_rec(1, "S|forward", 0, 0, 2), _rec(2, "S|forward", 0, 2, 5),
            _rec(3, "S|backward", 0, 5, 9), _rec(0, "S|step", None, 0, 10),
            _rec(5, "S|forward", 4, 20, 21), _rec(6, "S|backward", 4, 21, 22),
            _rec(4, "S|step", None, 20, 24),
            _rec(8, "S|forward", 7, 30, 31), _rec(9, "S|backward", 7, 31, 33),
            _rec(7, "S|step", None, 30, 35),
            _rec(11, "S|forward", 10, 40, 90), _rec(10, "S|step", None, 40, 99, True)]
    assert profiling.step_phases(recs)[0] == {"S|step": 10e6, "S|forward": 5e6,
                                              "S|backward": 4e6}
    assert profiling.phase_summary(recs) == {"steps": 3, "S|step": 5.0, "S|forward": 1.0,
                                             "S|backward": 2.0}
    assert profiling.phase_summary(recs[-2:]) == {}


def _event(name, start, end, device="CPU"):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=getattr(torch.autograd.DeviceType, device))


def test_launches_are_counted_by_the_innermost_phase():
    events = [_event("S|step", 0, 100), _event("S|forward", 10, 40), _event("S|backward", 40, 90),
              _event("S|step", 200, 300), _event("S|forward", 210, 240),
              _event("S|step", 0, 1000, device="CUDA"),  # a range's span on the device
              _event("cudaLaunchKernel", 5, 6), _event("cudaLaunchKernel", 20, 21),
              _event("cuLaunchKernel", 50, 51), _event("cudaGraphLaunch", 60, 61),
              _event("cudaLaunchKernelExC", 215, 216), _event("cudaMemcpyAsync", 30, 31),
              _event("cudaLaunchKernel", 150, 151), _event("cudaLaunchKernel", 500, 501),
              _event("aten::mul", 20, 22)]
    got = profile_train.launches_by_phase(events, 2)
    assert got == {"S|forward": 1.0, "S|backward": 1.0, "S|step": 0.5}
    assert collections.Counter(got).total() == 2.5
