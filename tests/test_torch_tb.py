"""The port's observability copies (yolov3_tpu_torch/utils/tb.py,
utils/profiling.py) against the JAX package's originals, on the CPU.

  * ``utils/tb.py`` is a framework-neutral copy with one paragraph added to
    its docstring, pinned to its original; the event files the two
    ``SummaryWriter``s write for the same scalars at a fixed wall time are
    byte-equal;
  * ``StepTimer`` is a copy of the original's class, pinned by source;
  * ``trace(dir)`` writes a ``torch.profiler`` Chrome trace into ``dir``.

Tolerance: none."""

import glob
import inspect
import json
import os
import time

import pytest
import torch

from yolov3_tpu.utils import profiling as jprofiling
from yolov3_tpu.utils import tb as jtb
from yolov3_tpu_torch.utils import profiling as tprofiling
from yolov3_tpu_torch.utils import tb as ttb

from .conftest import REPO
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

NOTE = ("\n\nFramework-neutral copy of ``yolov3_tpu/utils/tb.py`` (the port imports nothing of the\n"
        "JAX package). tests/test_torch_tb.py pins it to its original.\n")


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def test_tb_copy_matches_original():
    copy = _read("yolov3_tpu_torch", "utils", "tb.py")
    assert copy.count(NOTE) == 1
    original = _read("yolov3_tpu", "utils", "tb.py")
    assert copy.replace(NOTE, "", 1) == original.replace('\n"""', '"""', 1)


def test_step_timer_is_the_originals():
    assert inspect.getsource(tprofiling.StepTimer) == inspect.getsource(jprofiling.StepTimer)
    timer = tprofiling.StepTimer(images_per_step=8)
    assert timer.stats() == {}
    for _ in range(3):
        with timer:
            pass
    stats = timer.stats()
    assert stats["steps"] == 3 and stats["images_per_sec"] > 0


@pytest.mark.parametrize("scalars", [
    [({"train/total_loss": 3.25}, 1)],
    [({"train/total_loss": 2.5, "train/learning_rate": 1e-3, "train/loss_xy": -0.75}, 2),
     ({"val/total_loss": 1234.5678}, 2), ({"a": float("inf"), "b": 0.0}, 10 ** 9)]])
def test_event_files_are_byte_equal(tmp_path, monkeypatch, scalars):
    monkeypatch.setattr(time, "time", lambda: 1760000000.125)
    paths = []
    for name, module in (("jax", jtb), ("port", ttb)):
        with module.SummaryWriter(str(tmp_path / name)) as writer:
            for values, step in scalars:
                if len(values) == 1:
                    writer.add_scalar(*next(iter(values.items())), step=step)
                else:
                    writer.add_scalars(values, step=step)
        paths.append(writer.path)
    jax_path, port_path = paths
    assert os.path.basename(jax_path) == os.path.basename(port_path)
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        data = b.read()
        assert data == a.read() and len(data) > 0


def test_trace_writes_a_profiler_trace(tmp_path):
    with tprofiling.trace(None) as nothing:
        pass
    assert nothing is None
    with tprofiling.trace(str(tmp_path / "trace")) as path:
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert glob.glob(str(tmp_path / "trace" / "trace.*.json")) == [path]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
