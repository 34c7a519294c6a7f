"""The check rejects what it must, at a size the CPU holds: each fault a cell
can have, planted under the program's entry while the rest of a run goes on
as on the card (the look for a card skipped): an answer altered where it is
produced, one image answered with another's, half of the batch left out
(the mean taken over the rest), a train step that returns its state
unchanged; a sound run of the same size passes. And the control (the
reference one precision below the cell's, put in the program's place by
``control.py`` after a run) reads three times what a sound run of the
cell's own precision reads, and ``control.py`` judges it by the cell's own
limits. One card: no exchange between cards to leave out.

The controls and faults at the cells' own sizes run on the card through
``portbench/control.py``."""

import importlib
import json
import os

import pytest
import torch

from portbench import control
from portbench import run as R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]
INFER = [c for c in CELLS if ".infer_" in c]
TRAIN = [c for c in CELLS if ".train_" in c]
SEED = 2**31 + 99


def small(cell, monkeypatch):
    """The cell at a batch of 4 from two pool batches: inference at 128²,
    training at 64² in float32 (the CPU's bfloat16 convolutions round
    otherwise than the card's, and a sound float32 step agrees with the
    reference to its rounding, so only the fault moves the numbers)."""
    from portbench.modes import infer, train

    c = dict(R.load_json("portbench", "workloads", f"{cell}.json"), batch=4)
    monkeypatch.setattr(infer, "POOL_BATCHES", 2)
    monkeypatch.setattr(infer, "CALIBRATION_IMAGES", 4)
    monkeypatch.setattr(train, "POOL_BATCHES", 2)
    size = 128 if c["mode"] == "infer" else 64
    cfg = dict(R.load_json("portbench", "configs", f"{c['config']}.json"), image_size=size)
    if c["mode"] == "train":
        c["precision"] = "fp32"
    return c, cfg


def run_small(cell, monkeypatch):
    c, cfg = small(cell, monkeypatch)
    ctx = R.Context(cell, SEED, 0.5, 0, "cpu", config=cfg, cell=c)
    return R.run_cell(ctx)


def broken_predictor(monkeypatch, fault):
    from yolov3_tpu_torch.apps import inference_app

    real = inference_app.make_predictor

    def make(*args, **kwargs):
        predict = real(*args, **kwargs)

        def altered(images):
            b, c, s, sel, nv = (t.clone() for t in predict(images))
            rows, top = torch.arange(s.shape[0]), sel[:, 0].long()
            s[rows, top] = 1.0 - s[rows, top]
            b[rows, top] = b[rows, top] + 0.5
            c[rows, top] = (c[rows, top] + 1) % 80
            return b, c, s, sel, nv

        def half(images):
            n = images.shape[0] // 2
            out = predict(images[:n])
            return tuple(torch.cat([t, t], 0) for t in out)

        def one_image(images):
            out = tuple(t.clone() for t in predict(images))
            for t in out:
                t[0] = t[1]
            return out

        return {"answer_altered": altered, "half_batch": half, "one_image": one_image}[fault]

    monkeypatch.setattr(inference_app, "make_predictor", make)


def broken_step(monkeypatch, fault):
    from yolov3_tpu_torch.parallel import train_step

    real = train_step.make_train_step

    def make(spec, anchors, grids, batch, optimizer, **kwargs):
        if fault == "half_batch":
            step = real(spec, anchors, grids, batch // 2, optimizer, **kwargs)
            return lambda state, images, labels: step(state, images[:batch // 2],
                                                      labels[:batch // 2])
        step = real(spec, anchors, grids, batch, optimizer, **kwargs)
        return lambda state, images, labels: (state, step(state, images, labels)[1])

    monkeypatch.setattr(train_step, "make_train_step", make)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_small_run_passes(monkeypatch, cell):
    result = run_small(cell, monkeypatch)
    assert result["correct"], result["check"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch", "one_image"])
@pytest.mark.parametrize("cell", INFER)
def test_inference_faults_fail(monkeypatch, cell, fault):
    broken_predictor(monkeypatch, fault)
    result = run_small(cell, monkeypatch)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_training_faults_fail(monkeypatch, cell, fault):
    broken_step(monkeypatch, fault)
    result = run_small(cell, monkeypatch)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_separates_from_a_sound_run(monkeypatch, cell):
    """At this size the control reads at least three times what a sound run
    of the cell's own precision reads, in one of the cell's compared numbers
    (the cell's limits hold at its own size, where the card reads them)."""
    c, cfg = small(cell, monkeypatch)
    c["precision"] = R.load_json("portbench", "workloads", f"{cell}.json").get("precision")
    ctx = R.Context(cell, SEED, 0.5, 0, "cpu", config=cfg, cell=c)
    mode = importlib.import_module(f"portbench.modes.{c['mode']}")
    mode.run(ctx)
    stand = control.infer_stand_in if c["mode"] == "infer" else control.train_stand_in
    sound = mode.check(ctx, stand(ctx, ctx.evidence, "none"))
    numbers = mode.check(ctx, stand(ctx, ctx.evidence, "lower_precision"))
    assert any(numbers[n] > 0 and numbers[n] >= 3 * sound[n] for n in c["limits"]), (
        numbers, sound)


@pytest.mark.parametrize("cell", CELLS)
def test_control_judges_each_stand_in_by_the_cells_limits(monkeypatch, capsys, cell):
    """``control.py`` prints, for each stand-in, ``correct`` as the cell's own
    limits judge its numbers; the faults it plants come out not correct."""
    c, cfg = small(cell, monkeypatch)
    monkeypatch.setattr(R, "load_json", lambda *parts: (
        c if parts[1] == "workloads" else cfg))
    faults = ["one_image"] if c["mode"] == "infer" else ["unchanged", "half_batch"]
    assert control.main(["--workload", cell, "--seconds", "0.5", "--seeds", str(SEED),
                         "--device", "cpu", "--stand-ins", "none", *faults]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["stand_in"] for x in lines] == ["none", *faults]
    for x in lines:
        assert (x["correct"], x["check"]) == R.verdict(c["limits"], x["numbers"])
    assert lines[0]["correct"] and not any(x["correct"] for x in lines[1:]), lines
