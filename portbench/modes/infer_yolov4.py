"""YOLOv4 through the serving predictor: ``infer.py``'s traffic and loop,
YOLOv4's weights and check.

The run is ``infer.run`` as it stands (the staged uint8 pool, batch i =
(pool[i mod 8] + i) mod 256 ÷ 255, ``make_predictor`` of the cell's tier,
closed loop one batch ahead, NMS, the gather, detections to the host, the
reservoir sample, the traced stretch), with its seeded weights replaced by
``make_weights``': ``weights.make_weights``' kernels, gammas and head biases,
with two changes.

  * BatchNorm beta U(0.8, 1.2) in place of U(−0.2, 0.2). At the latter,
    YOLOv4's long plain chains of BatchNorm and a ReLU-like activation (the
    CSP transitions, the 35 convolutions of the neck) grow a perturbation
    ~1.16× a layer (mean-field theory of batch-normalized networks), and
    the network carries float32's rounding to 1e-4 of the heads and bf16's
    to their whole range: a sound bf16 forward then reads as far from the
    reference as a float8 one. Pre-activations centred near 1 sit where
    Mish and LeakyReLU are nearly linear, and the network holds a rounding
    near its size, as a trained one does (float32 1e-5, bf16's gaps a sixth
    of float8's; PERF.md §6, YOLOv4).
  * The running statistics are the batch statistics of a forward of the
    YOLOv4 reference (``reference/yolov4.py``'s ``MishTrainOps``) over
    ``STATS_IMAGES`` seeded images; ``weights.make_weights`` walks
    ``model.py``'s ops, which run every Mish layer as linear.

The check (``judge_yolov4``) reads ``judge.py``'s numbers with the YOLOv4
reference's forward (Mish) and decode (``scale_x_y``), and one more:

  * ``centre_drift_image_gap``: at the worst image, |the mean over its
    candidates of the port's centre minus the reference's, in grid cells,
    signed away from the middle of the candidate's cell|. The decode's
    ``scale_x_y`` term moves every centre away from its cell's middle by
    (s − 1)·|σ − ½|; rounding moves centres either way and averages out.

The cell's controls and faults (``STAND_INS``, ``stand_in``) replace the
program's outputs in what the check reads after a run, as ``control.py``'s
stand-ins do for a cell of mode ``infer``; the cell's limits judge them
(``run.verdict``). The benchmark's runs never use them. Stand-ins
(``none``: the program's own outputs, a sound run):

  * ``lower_precision``: the YOLOv4 reference one precision below bf16,
    float8 (``reference/lowp.py``'s rounding of every convolution's input
    and weight);
  * ``leaky_for_mish``: the float32 reference with every Mish layer run as
    LeakyReLU;
  * ``scale_x_y_one``: the float32 reference decoded with ``scale_x_y`` 1
    at every head;
  * ``half_batch``, ``one_image``: as ``control.py``'s.
"""

from __future__ import annotations

import torch

from .. import judge
from ..reference import detect as RD
from ..reference import yolov4 as R4
from ..reference.model import fold_bn, ieee_fp32, run_graph
from ..weights import STATS_IMAGES, generator
from ..weights import make_weights as make_base_weights
from . import infer

STAND_INS = ("none", "lower_precision", "leaky_for_mish", "scale_x_y_one", "half_batch",
             "one_image")
STATS_STREAM = 6  # the seed's generator stream of the betas and the statistics images
BETA = (0.8, 1.2)


@torch.no_grad()
def make_weights(graph, nclasses: int, seed: int, image_size: int, device):
    """``weights.make_weights``' draws, with the running statistics of the
    YOLOv4 reference's batch statistics (see the module's doc)."""
    params, state = make_base_weights(graph, nclasses, seed, image_size, device)
    g = generator(device, seed, STATS_STREAM)
    bn = [e["bn"] for sm_params in params.values() for e in sm_params.values() if "bn" in e]
    u = torch.rand(sum(b["beta"].numel() for b in bn), generator=g, device=device)
    at = 0
    for b in bn:
        n = b["beta"].numel()
        b["beta"] = BETA[0] + (BETA[1] - BETA[0]) * u[at:at + n]
        at += n
    images = torch.randint(0, 256, (STATS_IMAGES, image_size, image_size, 3), generator=g,
                           device=device).float() / 255.0
    ops = R4.MishTrainOps(params, state, nclasses, momentum=0.0)
    run_graph(graph, images, ops)
    for sm, layers in ops.new_state.items():
        for name, st in layers.items():
            state[sm][name] = {"mean": st["mean"].clone(), "var": st["var"].clone()}
    return params, state


def run(ctx):
    saved = infer.make_weights
    infer.make_weights = make_weights
    try:
        infer.run(ctx)
    finally:
        infer.make_weights = saved


def reference_ops(graph, params, state, config, rounding=None, mish_as="mish"):
    return R4.MishFloatOps(fold_bn(params, state), int(config["classes"]), rounding, mish_as)


def decoded(graph, ops, config, images, scales=None):
    """The reference's (boxes, objectness, class probabilities) of
    ``images``, ``judge.REF_BLOCK`` images at a time, and each candidate's
    grid size and cell (``reference/yolov4.py::candidate_cells``)."""
    scales = R4.head_scales(graph) if scales is None else scales
    parts, cells = [], None
    for a in range(0, images.shape[0], judge.REF_BLOCK):
        heads = run_graph(graph, images[a:a + judge.REF_BLOCK], ops)
        parts.append(R4.decode(heads, judge.anchors(config), int(config["classes"]), scales))
        cells = cells or R4.candidate_cells(heads)
    return tuple(torch.cat(p, 0) for p in zip(*parts)) + cells


@torch.no_grad()
def judge_yolov4(graph, params, state, config, cell, inputs, samples, device, ops=None):
    """``judge.judge_infer``'s numbers (see ``judge.py``) and
    ``centre_drift_image_gap``, against the YOLOv4 reference."""
    ieee_fp32()
    ops = ops or reference_ops(graph, params, state, config)
    nms = cell["nms"]
    out = {"score_gap": 0.0, "box_gap": 0.0, "class_gap": 0.0, "score_image_gap": 0.0,
           "box_image_gap": 0.0, "class_image_gap": 0.0, "centre_drift_image_gap": 0.0,
           "nms_mismatch": 0, "readback_mismatch": 0}
    for i, (bboxes, classes, scores, selected, num_valid), host in samples:
        boxes_r, conf_r, probs_r, grids, cells = decoded(graph, ops, config, inputs(i))
        best_r = probs_r.max(dim=-1).values
        picked = torch.gather(probs_r, -1, classes.long()[..., None])[..., 0]
        gaps = {"score": (scores - conf_r * best_r).abs(),
                "box": ((bboxes - boxes_r).abs() / (1.0 + boxes_r.abs())).amax(dim=-1),
                "class": conf_r * (best_r - picked)}
        for name, gap in gaps.items():
            out[f"{name}_gap"] = max(out[f"{name}_gap"], judge._worst(gap))
            out[f"{name}_image_gap"] = max(out[f"{name}_image_gap"],
                                           float(judge._image_mean(gap).max()))
        # centres in cells; away from the reference centre's cell middle is +
        centre_r = (boxes_r[..., :2] + boxes_r[..., 2:]) / 2 * grids[:, None]
        away = torch.sign(centre_r - cells - 0.5)
        drift = (((bboxes[..., :2] + bboxes[..., 2:]) / 2 * grids[:, None] - centre_r)
                 * away).mean(dim=-1)
        out["centre_drift_image_gap"] = max(out["centre_drift_image_gap"],
                                            float(judge._image_mean(drift).abs().max()))
        del boxes_r, conf_r, probs_r, best_r, picked, gaps, centre_r, away, drift
        sel_r, nv_r = RD.nms(bboxes, scores, nms["max_boxes"], nms["iou_threshold"],
                             nms["score_threshold"], nms["candidates"])
        sel_p, nv_p = selected.long().cpu(), num_valid.long().cpu()
        live = torch.arange(sel_p.shape[1])[None, :] < nv_p[:, None]
        differs = (nv_p != nv_r) | ((sel_p != sel_r) & live).any(dim=1)
        out["nms_mismatch"] += int(differs.sum())
        want = [t.cpu() for t in RD.gather(bboxes, classes, scores, selected, num_valid)]
        got = [t.cpu() for t in host]
        bad = torch.zeros(want[0].shape[0], dtype=torch.bool)
        for w, g in zip(want, got):
            same = (w == g) if w.shape == g.shape else torch.zeros_like(w, dtype=torch.bool)
            bad |= ~same.reshape(same.shape[0], -1).all(dim=1)
        out["readback_mismatch"] += int(bad.sum())
    return out


def check(ctx, evidence):
    """The check's numbers (``judge_yolov4``) of ``evidence``'s samples."""
    e = evidence
    return judge_yolov4(e["graph"], e["params"], e["state"], ctx.config, ctx.cell, e["inputs"],
                        e["samples"], ctx.device)


def stand_in(ctx, evidence, name):
    """``evidence`` with the program's outputs replaced by stand-in
    ``name``'s (see the module's doc)."""
    from .. import control
    from ..reference import lowp

    if name in ("none", "half_batch", "one_image"):
        return control.infer_stand_in(ctx, evidence, name)
    e, nms = evidence, ctx.cell["nms"]
    ops = reference_ops(e["graph"], e["params"], e["state"], ctx.config,
                        rounding=lowp.Float8Rounding() if name == "lower_precision" else None,
                        mish_as="leaky" if name == "leaky_for_mish" else "mish")
    scales = [1.0] * len(R4.head_scales(e["graph"])) if name == "scale_x_y_one" else None
    samples = []
    for i, _, _ in e["samples"]:
        with torch.no_grad():
            boxes, conf, probs, _, _ = decoded(e["graph"], ops, ctx.config, e["inputs"](i), scales)
            scores, classes = RD.scores_classes(conf, probs)
            sel, nv = RD.nms(boxes, scores, nms["max_boxes"], nms["iou_threshold"],
                             nms["score_threshold"], nms["candidates"])
            out = (boxes, classes, scores, sel.to(ctx.device), nv.to(ctx.device))
            host = tuple(t.cpu() for t in RD.gather(*out))
        samples.append((i, out, host))
    return dict(e, samples=samples)
