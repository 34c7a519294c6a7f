"""Training through the port's train step, steps queued without waiting.

Set-up builds one train step (``make_train_step`` with Adam at the cell's
learning rate and the cell's compute precision against float32 masters, no
augmentation) and one train state (``init_train_state`` over the seeded
weights), stages the uint8 image pool and the label pool of
``POOL_BATCHES`` batches (``traffic.py``), and drives that state through its
first ``CHECKED_STEPS`` steps with the window's own call and feed, on
distinct rows: the first step builds and plans every kernel. What the check
needs is taken from them: each step's loss, the first moment and the
BatchNorm state after step 1 (the first gradient as Adam got it) and, after
the last, the parameters and the BatchNorm state, copied to the host. The
same state then goes on into the window.

Step i takes pool batch i mod P, its pixels ``+ i mod 256``, and label
batch i mod P. The window queues steps without waiting for the device, as
the trainer's loop does, until ``--seconds`` have passed since the first,
then waits for the last: only finished steps count. The step after the
window's last is checked too, through the same call on the same state: its
state before and after (parameters, BatchNorm state, Adam's moments and
count) is copied on the device and then to the host. A traced run then
profiles ``TRACE_STEPS`` more.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import traffic
from ..judge import anchors, compare_train, reference_train
from ..reference import train as RT
from ..reference.graph import load_graph
from ..weights import make_weights
from . import span

PRECISION = {"bf16": torch.bfloat16, "fp32": None}
POOL_BATCHES = 8
CHECKED_STEPS = 3
TRACE_STEPS = 10


def _host(tree) -> dict:
    return {k: v.detach().cpu() for k, v in RT.leaves(tree).items()}


def _held(ts) -> dict:
    """The train state's parameters, BatchNorm state and Adam's moments and
    count, as leaves."""
    opt = ts["opt_state"]
    return {"params": RT.leaves(ts["params"]), "state": RT.leaves(ts["bn_state"]),
            "mu": RT.leaves(opt["mu"]), "nu": RT.leaves(opt["nu"]), "count": opt["count"]}


def _copy(held) -> dict:
    """``held`` copied on the device: a later step may update it in place."""
    return {k: (v.detach().clone() if k == "count" else
                {n: t.detach().clone() for n, t in v.items()}) for k, v in held.items()}


def _to_host(held) -> dict:
    return {k: (int(v) if k == "count" else {n: t.cpu() for n, t in v.items()})
            for k, v in held.items()}


def run(ctx):
    cfg, cell, dev, seed = ctx.config, ctx.cell, ctx.device, ctx.seed
    size, batch, nclasses = int(cfg["image_size"]), int(cell["batch"]), int(cfg["classes"])
    graph = load_graph(ctx.path(cfg["model"]), nclasses)
    params, state = make_weights(graph, nclasses, seed, size, dev)
    ctx.mark("weights")
    pool = traffic.image_pool(seed, POOL_BATCHES, batch, size, dev)
    labels = traffic.label_pool(seed, POOL_BATCHES, batch, cell, nclasses, dev)
    table = anchors(cfg)

    ctx.mark("inputs")
    from yolov3_tpu_torch.models import parse_model_config
    from yolov3_tpu_torch.models.network import head_grid_sizes
    from yolov3_tpu_torch.parallel.train_step import init_train_state, make_adam, make_train_step

    spec = parse_model_config(ctx.path(cfg["model"]), nclasses)
    optimizer = make_adam(float(cell["learning_rate"]))
    step = make_train_step(spec, table, head_grid_sizes(spec, size), batch, optimizer,
                           compute_dtype=PRECISION[cell["precision"]])
    state_now = init_train_state(params, state, optimizer)

    ctx.mark("train step")

    def feed(i):
        with span("input"):
            return traffic.derived(pool, i), labels[i % POOL_BATCHES]

    def one(i):
        nonlocal state_now
        images, rows = feed(i)
        t0 = time.perf_counter()
        with span("step"):
            state_now, metrics = step(state_now, images, rows)
        return time.perf_counter() - t0, metrics

    losses = []
    for i in range(CHECKED_STEPS):
        _, metrics = one(i)
        losses.append(metrics["total_loss"])
        if i == 0:
            grad1 = {k: (v / (1 - RT.ADAM_B1)).cpu()
                     for k, v in RT.leaves(state_now["opt_state"]["mu"]).items()}
            state1 = _host(state_now["bn_state"])
    port = {"losses": [float(v) for v in losses], "grad1": grad1, "state1": state1,
            "params": _host(state_now["params"]), "state": _host(state_now["bn_state"])}
    ctx.sync()
    ctx.setup_done()

    start, i, host = time.perf_counter(), CHECKED_STEPS, []
    while time.perf_counter() - start < ctx.seconds:
        seconds, metrics = one(i)
        host.append(seconds)
        i += 1
    last_loss = float(metrics["total_loss"])  # waits for the last step
    end = time.perf_counter()
    steps = i - CHECKED_STEPS
    ctx.window = {"seconds": end - start, "images": steps * batch, "steps": steps}
    ctx.spans = {"step": host}
    ctx.e2e = {"train_images_per_s": steps * batch / (end - start)}
    ctx.attempted, ctx.failed = steps * batch, 0 if np.isfinite(last_loss) else steps * batch

    checked_at, before = i, _copy(_held(state_now))
    _, metrics = one(i)
    after = _copy(_held(state_now))
    i += 1

    if ctx.trace:
        first = i

        def stretch():
            for j in range(first, first + TRACE_STEPS):
                one(j)

        ctx.profile(stretch, TRACE_STEPS)

    ctx.read_memory()
    b, a = _to_host(before), _to_host(after)
    loss = float(metrics["total_loss"])
    del state_now, step, metrics, before, after
    ctx.free()
    grad = {k: (a["mu"][k] - RT.ADAM_B1 * b["mu"][k]) / (1 - RT.ADAM_B1) for k in b["mu"]}
    ctx.evidence = {
        "graph": graph, "params": params, "state": state, "feed": feed, "port": port,
        "window": {"index": checked_at, "before": b,
                   "port": {"losses": [loss], "grad1": grad, "state1": a["state"],
                            "params": a["params"], "state": a["state"]}}}


def window_start(ctx, evidence):
    """The port's parameters and BatchNorm state before the step after the
    window, on the run's device → (params, state, their leaves)."""
    e, before = evidence, evidence["window"]["before"]
    p0 = {k: v.to(ctx.device) for k, v in before["params"].items()}
    s0 = {k: v.to(ctx.device) for k, v in before["state"].items()}
    return RT.rebuild(e["params"], p0), RT.rebuild(e["state"], s0), p0, s0


def check(ctx, evidence):
    """The check's numbers (``judge.compare_train``) over the first steps
    and, under ``window_``, over the step after the window."""
    e, cell = evidence, ctx.cell
    cfg = dict(ctx.config, model_path=ctx.path(ctx.config["model"]))
    batches = [e["feed"](j) for j in range(CHECKED_STEPS)]
    ref = reference_train(e["graph"], e["params"], e["state"], cfg, cell, batches)
    out = compare_train(RT.leaves(e["params"]), RT.leaves(e["state"]), e["port"], ref)
    del ref
    w = e["window"]
    params, state, p0, s0 = window_start(ctx, e)
    wref = reference_train(e["graph"], params, state, cfg, cell, [e["feed"](w["index"])],
                           start=w["before"])
    out.update({f"window_{k}": v for k, v in compare_train(p0, s0, w["port"], wref).items()})
    return out
