"""The train step's phase readers (``program_spans.py`` and the six
``metrics/*.train.py`` that read it) on a synthetic trace and synthetic span
records, against values worked out by hand; with nothing to read they
return None."""

import collections

import pytest

from portbench import program_spans
from portbench.records import Records, reader
from portbench.trace import Trace

Span = collections.namedtuple("Span", "id name parent start_ns end_ns profiled")
PHASE_READERS = ("forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train",
                 "loss_host_ms.train", "anchors_host_ms.train")


def records(trace=None):
    return Records({"precision": "bf16"}, {}, {}, 1, {}, {}, trace)


def host_trace(host, units=2):
    return Trace([], (0.0, 1000.0), [], list(host), units)


def ms(i, name, parent, start, end, profiled=False):
    return Span(i, name, parent, int(start * 1e6), int(end * 1e6), profiled)


def test_launches_inside_step_ranges_on_any_thread_are_counted():
    host = [
        (0.0, 100.0, 1, "S|step"), (10.0, 40.0, 2, "S|forward"), (40.0, 90.0, 2, "S|backward"),
        (200.0, 300.0, 1, "S|step"),
        (5.0, 6.0, 3, "cudaLaunchKernel"),        # in the step, outside its phases
        (20.0, 21.0, 4, "cudaLaunchKernel"),      # main thread, forward
        (50.0, 51.0, 0, "cudaLaunchKernel"),      # the autograd engine's thread, backward
        (60.0, 61.0, 1, "cuLaunchKernel"),        # a Triton kernel, `cu` API
        (70.0, 71.0, 1, "cudaGraphLaunch"),       # a graph counts once
        (80.0, 81.0, 1, "cudaLaunchKernelExC_v11060"),
        (210.0, 211.0, 3, "cuLaunchKernelEx"),
        (30.0, 31.0, 3, "cudaMemcpyAsync"), (32.0, 33.0, 3, "cudaMemsetAsync"),
        (35.0, 36.0, 3, "aten::mul"),
        (150.0, 151.0, 0, "cudaLaunchKernel"),    # between the steps: the loop's own
        (500.0, 501.0, 0, "cudaLaunchKernel"),    # the profiler's pads
    ]
    assert program_spans.step_launches(host_trace(host)) == pytest.approx(7 / 2)
    assert reader("step_launches.train")(records(host_trace(host))) == pytest.approx(3.5)


def test_launches_are_divided_by_the_number_of_step_ranges():
    host = [(0.0, 10.0, 1, "S|step"), (20.0, 30.0, 1, "S|step"), (40.0, 50.0, 1, "S|step"),
            (1.0, 2.0, 2, "cudaLaunchKernel"), (21.0, 22.0, 2, "cudaLaunchKernel"),
            (23.0, 24.0, 2, "cudaLaunchKernel")]
    assert program_spans.step_launches(host_trace(host, units=10)) == pytest.approx(1.0)


def test_launches_read_nothing_without_a_trace_or_a_step_range():
    assert reader("step_launches.train")(records(None)) is None
    assert program_spans.step_launches(host_trace([(0.0, 5.0, 1, "cudaLaunchKernel"),
                                                   (0.0, 9.0, 0, "portbench|step")])) is None


SPANS = [
    # step 1: forward, loss and backward twice (gradient accumulation)
    ms(28, "S|anchors", 0, 0, 0.25),
    ms(1, "S|assign", 0, 0, 1), ms(2, "S|forward", 0, 1, 3), ms(3, "S|loss", 0, 3, 4),
    ms(4, "S|backward", 0, 4, 8), ms(5, "S|assign", 0, 8, 9), ms(6, "S|forward", 0, 9, 10),
    ms(7, "S|loss", 0, 10, 12), ms(8, "S|backward", 0, 12, 15),
    ms(9, "S|optimizer", 0, 15, 20), ms(0, "S|step", None, 0, 21),
    # steps 2 and 3
    ms(29, "S|anchors", 10, 30, 30.5),
    ms(11, "S|assign", 10, 30, 30.5), ms(12, "S|forward", 10, 30.5, 32),
    ms(13, "S|loss", 10, 32, 33), ms(14, "S|backward", 10, 33, 36),
    ms(15, "S|optimizer", 10, 36, 40),
    ms(10, "S|step", None, 30, 40),
    ms(30, "S|anchors", 16, 50, 52), ms(17, "S|assign", 16, 50, 51),
    ms(18, "S|forward", 16, 51, 55), ms(19, "S|loss", 16, 55, 57),
    ms(20, "S|backward", 16, 57, 60), ms(21, "S|optimizer", 16, 60, 61),
    ms(16, "S|step", None, 50, 62),
    # a profiled step and an eval step: left out
    ms(23, "S|forward", 22, 70, 170, True), ms(24, "S|optimizer", 22, 170, 270, True),
    ms(22, "S|step", None, 70, 280, True),
    ms(26, "S|forward", 25, 300, 400), ms(27, "S|loss", 25, 400, 500),
    ms(25, "S|eval", None, 300, 500),
]


def test_phase_medians_sum_repeats_within_a_step_over_unprofiled_steps(monkeypatch):
    # step 1: forward 2 + 1, loss 1+1 + 1+2, backward 4 + 3, optimizer 5
    # step 2: forward 1.5, loss 0.5 + 1, backward 3, optimizer 4
    # step 3: forward 4, loss 1 + 2, backward 3, optimizer 1
    assert program_spans.phase_ms(SPANS, ("S|forward",)) == pytest.approx(3.0)
    assert program_spans.phase_ms(SPANS, ("S|assign", "S|loss")) == pytest.approx(3.0)
    assert program_spans.phase_ms(SPANS, ("S|backward",)) == pytest.approx(3.0)
    assert program_spans.phase_ms(SPANS, ("S|optimizer",)) == pytest.approx(4.0)
    monkeypatch.setattr(program_spans, "records", lambda: SPANS)
    got = {name: reader(name)(records()) for name in PHASE_READERS}
    assert got == pytest.approx({"forward_host_ms.train": 3.0, "backward_host_ms.train": 3.0,
                                 "optimizer_host_ms.train": 4.0, "loss_host_ms.train": 3.0,
                                 "anchors_host_ms.train": 0.5})


def test_a_phase_a_step_lacks_counts_zero_there():
    spans = [ms(1, "S|augment", 0, 0, 2), ms(0, "S|step", None, 0, 3),
             ms(3, "S|forward", 2, 10, 11), ms(2, "S|step", None, 10, 12),
             ms(5, "S|forward", 4, 20, 21), ms(4, "S|step", None, 20, 22)]
    assert program_spans.phase_ms(spans, ("S|augment",)) == 0.0
    assert program_spans.phase_ms(spans, ("S|allreduce",)) is None


def test_phase_readers_read_nothing_without_records(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: ())
    assert all(reader(name)(records()) is None for name in PHASE_READERS)
    only_profiled = [s for s in SPANS if s.profiled]
    monkeypatch.setattr(program_spans, "records", lambda: only_profiled)
    assert all(reader(name)(records()) is None for name in PHASE_READERS)


def test_a_program_without_spans_gives_no_records(monkeypatch):
    import yolov3_tpu_torch.utils.profiling as profiling

    assert isinstance(program_spans.records(), tuple)
    monkeypatch.delattr(profiling, "span_records")
    assert program_spans.records() == ()
