"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/``), which works everything out
again from the benchmark's own weights and inputs.

Inference, for each sampled window batch (all its images, every candidate):

  * ``score_gap``: the largest |score − the reference's score| over every
    candidate (score = objectness × best class probability, in [0, 1]);
  * ``box_gap``: the largest |corner − the reference's| / (1 + |the
    reference's corner|);
  * ``class_gap``: the largest score the port's class gives up against the
    reference's best class, objectness × (best probability − the
    probability of the port's class), at every candidate;
  * ``nms_mismatch``: images whose selection (indices and count) differs
    from the reference's suppression run over the port's own boxes and
    scores: exact;
  * ``readback_mismatch``: images whose detections on the host differ from
    the port's outputs gathered at its selection: exact;
  * ``score_image_gap``, ``box_image_gap``, ``class_image_gap``: the same
    gaps' mean over one image's candidates (a box's gap is its worst
    corner's), at the worst image of the batch: a fault in one image shows
    in full, not as a 128th of it.

Training, over the first steps the set-up ran through the window's own call
(leaves of the port's nested dicts; a leaf's gap is |‖port‖ − ‖reference‖|
over the larger of the reference's norm of that leaf and of the median
leaf):

  * ``loss1_gap``: the first step's loss, relative; ``loss_gap``: the worst
    step's;
  * ``grad_gap`` / ``grad_median_gap``: the first gradient as Adam got it
    (its first moment after one step over 1 − b1), worst and median leaf;
  * ``change_gap`` / ``change_median_gap``: the parameters' change over the
    steps, worst and median leaf, leaving out leaves whose reference
    gradient norm is under a thousandth of the median leaf's (they move by
    round-off alone under Adam);
  * ``bn_gap`` / ``bn_median_gap``: the BatchNorm running statistics'
    change, worst and median leaf; ``bn1_gap`` / ``bn1_median_gap`` the
    same after the first step;

and ``window_`` and the same names over the step that follows the window,
which the reference takes from the port's own state before it (parameters,
BatchNorm state, Adam's moments and count): its gradient is worked out from
Adam's first moment before and after, (mu' − b1·mu) / (1 − b1).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .reference import detect as RD
from .reference import train as RT
from .reference.graph import decay_factor
from .reference.int8 import Int8Ops, int8_model
from .reference.model import FloatOps, fold_bn, ieee_fp32, run_graph

REF_BLOCK = 32  # images a reference forward takes at once


def anchors(config):
    """The configuration's anchors as (heads, 3, 2), the 13-grid head first."""
    return np.asarray(config["anchors"], np.float32).reshape(-1, 3, 2)


def _worst(gap) -> float:
    """The largest entry of a gap tensor; a NaN anywhere reads infinite."""
    return float(torch.where(torch.isnan(gap), float("inf"), gap).max())


def reference_ops(graph, params, state, config, cell, calib, device, lattice=None,
                  rounding=None):
    """The reference forward of the cell's tier (``lattice``/``rounding``:
    the controls of ``reference/lowp.py``)."""
    nclasses = int(config["classes"])
    if cell["tier"] == "int8_chain":
        images = torch.as_tensor(np.asarray(calib), device=device)
        return Int8Ops(int8_model(graph, params, state, nclasses, images, lattice or 127),
                       nclasses, lattice or 127)
    return FloatOps(fold_bn(params, state), nclasses, rounding)


def decoded(graph, ops, config, images):
    """The reference's (boxes, objectness, class probabilities) of ``images``."""
    parts = [RD.decode(run_graph(graph, images[a:a + REF_BLOCK], ops), config["anchors_table"],
                       int(config["classes"]))
             for a in range(0, images.shape[0], REF_BLOCK)]
    return tuple(torch.cat(p, 0) for p in zip(*parts))


def _image_mean(gap):
    """(B,) the gap's mean over each image's candidates; a NaN reads infinite."""
    return torch.nan_to_num(gap.double(), nan=float("inf")).reshape(gap.shape[0], -1).mean(1)


@torch.no_grad()
def judge_infer(graph, params, state, config, cell, calib, inputs, samples, device, ops=None):
    """``samples``: [(batch index, the predictor's outputs (bboxes, classes,
    scores, selected, num_valid), the detections on the host (boxes,
    classes, scores, valid))] → the numbers of the module's doc."""
    ieee_fp32()
    config = dict(config, anchors_table=anchors(config))
    ops = ops or reference_ops(graph, params, state, config, cell, calib, device)
    nms = cell["nms"]
    out = {"score_gap": 0.0, "box_gap": 0.0, "class_gap": 0.0, "score_image_gap": 0.0,
           "box_image_gap": 0.0, "class_image_gap": 0.0, "nms_mismatch": 0,
           "readback_mismatch": 0}
    for i, (bboxes, classes, scores, selected, num_valid), host in samples:
        boxes_r, conf_r, probs_r = decoded(graph, ops, config, inputs(i))
        best_r = probs_r.max(dim=-1).values
        picked = torch.gather(probs_r, -1, classes.long()[..., None])[..., 0]
        gaps = {"score": (scores - conf_r * best_r).abs(),
                "box": ((bboxes - boxes_r).abs() / (1.0 + boxes_r.abs())).amax(dim=-1),
                "class": conf_r * (best_r - picked)}
        for name, gap in gaps.items():
            out[f"{name}_gap"] = max(out[f"{name}_gap"], _worst(gap))
            out[f"{name}_image_gap"] = max(out[f"{name}_image_gap"],
                                           float(_image_mean(gap).max()))
        del boxes_r, conf_r, probs_r, best_r, picked, gaps
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


def _norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _leaf_gaps(port: dict, ref: dict, keys, what: str = "") -> list:
    med = float(np.median([ref[k] for k in keys]))
    gaps = {k: abs(port[k] - ref[k]) / max(ref[k], med) for k in keys if max(ref[k], med) > 0}
    if what:
        worst = sorted(gaps, key=gaps.get)[-3:]
        print(f"judge: {what} worst leaves " + ", ".join(
            f"{k} {gaps[k]!r} (port {port[k]!r}, reference {ref[k]!r})" for k in worst),
            file=sys.stderr)
    return list(gaps.values())


def reference_train(graph, params, state, config, cell, batches, rounding=None, start=None):
    """The reference's steps over ``batches`` from ``params`` / ``state``
    and, where given, ``start``'s Adam moments and count (see
    ``reference/train.py``)."""
    ieee_fp32()
    table = torch.as_tensor(anchors(config), device=batches[0][0].device)
    return RT.adam_steps(graph, params, state, int(config["classes"]), table, batches,
                         float(cell["learning_rate"]), decay_factor(config["model_path"]),
                         rounding, start)


def compare_train(p0: dict, s0: dict, port: dict, ref: dict) -> dict:
    """``p0`` / ``s0``: the parameters' and the BatchNorm state's leaves the
    steps started from; ``port`` / ``ref``: {"losses", "grad1", "state1",
    "params", "state"} (leaves as ``reference.train.leaves``) → the numbers
    of the module's doc."""
    loss = [abs(a - b) / abs(b) for a, b in zip(port["losses"], ref["losses"])]
    g_ref, g_port = _norms(ref["grad1"]), _norms(port["grad1"])
    grads = _leaf_gaps(g_port, g_ref, list(g_ref), "first gradient")
    med = float(np.median(list(g_ref.values())))
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * med]

    def moved(after, start, keys):
        return _norms({k: after[k].to(start[k].device) - start[k] for k in keys})

    change = _leaf_gaps(moved(port["params"], p0, moving), moved(ref["params"], p0, moving),
                        moving, "change")
    bn = _leaf_gaps(moved(port["state"], s0, s0), moved(ref["state"], s0, s0), list(s0),
                    "BatchNorm state")
    bn1 = _leaf_gaps(moved(port["state1"], s0, s0), moved(ref["state1"], s0, s0), list(s0),
                     "BatchNorm state after step 1")
    finite = all(np.isfinite(port["losses"]))
    return {"loss1_gap": loss[0] if finite else float("inf"),
            "loss_gap": max(loss) if finite else float("inf"),
            "grad_gap": max(grads), "grad_median_gap": float(np.median(grads)),
            "change_gap": max(change), "change_median_gap": float(np.median(change)),
            "bn_gap": max(bn), "bn_median_gap": float(np.median(bn)),
            "bn1_gap": max(bn1), "bn1_median_gap": float(np.median(bn1))}
