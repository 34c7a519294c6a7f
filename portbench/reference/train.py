"""One YOLOv3 training step in plain float32 PyTorch: target assignment, the
four-term loss, L2 on the kernels, the gradients by autograd, Adam.

The loss is the one the repository trains with, from its stated contract
(``ops/loss.py``'s docstring: the reference Keras loss, with its documented
departures from Darknet's):

  * assignment: each label row [xmin, ymin, xmax, ymax, obj, cls] goes to
    the anchor of best width/height IoU over all anchors (the first among
    ties), at the cell ``trunc(centre · g)`` (clipped to the grid) of the
    head that owns that anchor; padded rows (obj 0) go nowhere; where two
    rows meet in one slot, the later row wins;
  * xy: Σ obj · (2 − w·h) · ‖(centre·g − cell) − sigmoid(t_xy)‖²;
    wh: Σ obj · (2 − w·h) · ‖log(wh / anchor) − t_wh‖² (log's ±inf and NaN
    read 0);
  * objectness: binary cross-entropy of sigmoid(t_obj) against obj over
    every slot, probabilities clipped to [1e-7, 1 − 1e-7];
  * class: Σ obj · (logsumexp(l) − l[cls]), l = log(clip(sigmoid(t_cls)));
  * total = Σ terms / batch + 0.0005 · Σ kernel² (the float32 masters);
  * Adam (b1 0.9, b2 0.999, eps 1e-7 added outside the root of the
    bias-corrected second moment, corrections 1 − b^t in float32).

Training-mode BatchNorm and the forward are ``model.TrainOps``.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import TrainOps, run_graph

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7
EPS = 1e-7


def assign(labels, anchors, grid_sizes):
    """labels (B, M, 6), anchors (S, 3, 2) → per head (B, g, g, 3, 6) targets."""
    labels = labels.float()
    b, m, f = labels.shape
    flat = anchors.reshape(-1, 2)
    wh = (labels[..., 2:4] - labels[..., 0:2])[..., None, :]
    inter = torch.minimum(wh[..., 0], flat[:, 0]) * torch.minimum(wh[..., 1], flat[:, 1])
    iou = inter / (wh[..., 0] * wh[..., 1] + flat[:, 0] * flat[:, 1] - inter)
    best = torch.argmax(iou, dim=-1)  # the first maximum
    centre = (labels[..., 0:2] + labels[..., 2:4]) / 2.0
    best, centre, lab = best.cpu().numpy(), centre.cpu().numpy(), labels.cpu().numpy()
    out = []
    for s, g in enumerate(grid_sizes):
        grid = np.zeros((b, g, g, 3, f), dtype=np.float32)
        rows = np.clip((centre[..., 1] * np.float32(g)).astype(np.int32), 0, g - 1)
        cols = np.clip((centre[..., 0] * np.float32(g)).astype(np.int32), 0, g - 1)
        for bi in range(b):
            for mi in range(m):  # in row order: a later row overwrites
                if lab[bi, mi, 4] != 0 and best[bi, mi] // 3 == s:
                    grid[bi, rows[bi, mi], cols[bi, mi], best[bi, mi] % 3] = lab[bi, mi]
        out.append(torch.from_numpy(grid).to(labels.device))
    return out


def _clip(p):
    return torch.clamp(p, EPS, 1.0 - EPS)


def loss_terms(y_true, y_pred, anchors):
    """(4,) [xy, wh, obj, class] summed over the batch."""
    y_pred = y_pred.float()
    g = y_true.shape[1]
    box, obj, cls = y_true[..., 0:4], y_true[..., 4], y_true[..., 5].long()
    true_wh = box[..., 2:4] - box[..., 0:2]
    scale = 2.0 - true_wh[..., 0] * true_wh[..., 1]
    idx = torch.arange(g, dtype=torch.float32, device=y_true.device)
    cells = torch.stack([idx[None, :].expand(g, g), idx[:, None].expand(g, g)], -1)
    cells = cells[None, :, :, None]
    true_xy = (box[..., 0:2] + box[..., 2:4]) / 2.0 * g - cells
    t_wh = torch.log(true_wh / anchors)
    t_wh = torch.where(torch.isfinite(t_wh), t_wh, torch.zeros_like(t_wh))
    xy = torch.sum(obj * scale * torch.sum((true_xy - torch.sigmoid(y_pred[..., 0:2])) ** 2, -1))
    wh = torch.sum(obj * scale * torch.sum((t_wh - y_pred[..., 2:4]) ** 2, -1))
    p = _clip(torch.sigmoid(y_pred[..., 4]))
    obj_loss = torch.sum(-(obj * torch.log(p) + (1.0 - obj) * torch.log(1.0 - p)))
    logp = torch.log(_clip(torch.sigmoid(y_pred[..., 5:])))
    picked = torch.gather(logp, -1, cls[..., None])[..., 0]
    cls_loss = torch.sum(obj * (torch.logsumexp(logp, -1) - picked))
    return torch.stack([xy, wh, obj_loss, cls_loss])


def loss(graph, params, state, nclasses, anchors, images, labels, decay, rounding=None):
    """→ (total loss, the BatchNorm state after this batch)."""
    ops = TrainOps(params, state, nclasses, rounding)
    heads = run_graph(graph, images, ops)
    targets = assign(labels, anchors, [h.shape[1] for h in heads])
    terms = sum(loss_terms(t, h, a) for t, h, a in zip(targets, heads, anchors))
    l2 = decay * sum(torch.sum(e["kernel"] ** 2) for sm in params.values() for e in sm.values())
    return torch.sum(terms) / images.shape[0] + l2, ops.new_state


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def leaves(tree) -> dict:
    """{path: tensor} of a nested dict, paths joined by '/'."""
    return {"/".join(p): t for p, t in _leaves(tree)}


def rebuild(tree, flat, prefix=()):
    """``flat`` ({path: tensor}) in the nesting of ``tree``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, flat, prefix + (k,)) for k, v in tree.items()}
    return flat["/".join(prefix)]


def adam_steps(graph, params, state, nclasses, anchors, batches, lr, decay, rounding=None,
               start=None):
    """Train ``len(batches)`` steps of (images, labels) from ``params`` /
    ``state`` and Adam at zero, or at ``start`` ({"mu", "nu": {leaf:
    moment}, "count": steps taken}) → {"losses": [float], "grad1": {leaf:
    first gradient}, "state1": {leaf: BN state after the first step},
    "params": {leaf: params after}, "state": {leaf: BN state after}}."""
    p = {k: v.detach().clone() for k, v in leaves(params).items()}
    if start is None:
        start = {"mu": {k: torch.zeros_like(v) for k, v in p.items()},
                 "nu": {k: torch.zeros_like(v) for k, v in p.items()}, "count": 0}
    mu = {k: start["mu"][k].to(v.device) for k, v in p.items()}
    nu = {k: start["nu"][k].to(v.device) for k, v in p.items()}
    st = state
    out = {"losses": []}
    for count, (images, labels) in enumerate(batches, start=int(start["count"]) + 1):
        live = {k: v.requires_grad_(True) for k, v in p.items()}
        total, st = loss(graph, rebuild(params, live), st, nclasses, anchors, images, labels,
                         decay, rounding)
        grads = dict(zip(live, torch.autograd.grad(total, list(live.values()))))
        out["losses"].append(float(total.detach()))
        if "grad1" not in out:
            out["grad1"] = {k: g.detach().clone() for k, g in grads.items()}
            out["state1"] = leaves(st)
        bc1 = float(1 - torch.tensor(ADAM_B1) ** count)
        bc2 = float(1 - torch.tensor(ADAM_B2) ** count)
        with torch.no_grad():
            for k in p:
                g = grads[k]
                mu[k] = g * (1 - ADAM_B1) + mu[k] * ADAM_B1
                nu[k] = g * g * (1 - ADAM_B2) + nu[k] * ADAM_B2
                p[k] = p[k].detach() - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
        del live, grads, total
    out["params"] = {k: v.detach() for k, v in p.items()}
    out["state"] = leaves(st)
    return out
