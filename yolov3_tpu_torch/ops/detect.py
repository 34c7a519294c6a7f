"""Fused detection path: heads → compact detections, minimal math.

Counterpart of ``yolov3_tpu/ops/detect.py``. Semantically identical to
yolo_decode ∘ yolo_nms ∘ gather_detections but restructured:

  * score = sigmoid(obj) · sigmoid(max class logit) — sigmoid is monotonic,
    so the max over class *logits* gives the same best class / best prob
    without a sigmoid over the full (B, N, nc) tensor;
  * box decode (cell offsets, exp(wh)·anchors) runs only for the top-K NMS
    candidates instead of all N anchors;
  * suppression through ``ops/cuda/nms_kernel.py::suppression_sweep`` — on
    the card K1, which takes K ≤ 1,300 — and compaction as in ops/nms.py.

Exactness: identical outputs whenever fewer than K candidates beat the
score threshold (same caveat as yolo_nms's top-K).
"""

from __future__ import annotations

import torch

from .cuda.nms_kernel import suppression_sweep
from .nms import _compact, _pairwise_iou


def _flatten_head_fields(outputs, anchors_table):
    """Per-scale → flattened (B, N, …) logits + per-anchor geometry tables."""
    xy_l, wh_l, obj_l, cls_l = [], [], [], []
    offsets_all, scales_all, anchors_all = [], [], []
    for grid_out, anchors in zip(outputs, anchors_table):
        b, gh, gw, na, _ = grid_out.shape
        dev = grid_out.device
        g = grid_out.float().reshape(b, gh * gw * na, -1)
        xy_l.append(g[..., 0:2])
        wh_l.append(g[..., 2:4])
        obj_l.append(g[..., 4])
        cls_l.append(g[..., 5:])
        row, col = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=dev),
                                  torch.arange(gw, dtype=torch.float32, device=dev),
                                  indexing="ij")
        offsets = torch.stack([col, row], -1)[:, :, None, :].expand(gh, gw, na, 2)
        offsets_all.append(offsets.reshape(-1, 2))
        scales_all.append(torch.tensor([gw, gh], dtype=torch.float32, device=dev)
                          .expand(gh * gw * na, 2))
        anchors_all.append(anchors.expand(gh * gw, na, 2).reshape(-1, 2))
    return (
        torch.cat(xy_l, 1), torch.cat(wh_l, 1), torch.cat(obj_l, 1), torch.cat(cls_l, 1),
        torch.cat(offsets_all, 0), torch.cat(scales_all, 0), torch.cat(anchors_all, 0),
    )


def detect(outputs, anchors_table, nclasses: int, max_boxes: int = 100,
           iou_threshold: float = 0.5, score_threshold: float = 0.25,
           num_candidates: int = 256, scales=None):
    """Raw head outputs (list of (B, g, g, 3, 5+nc)) → (boxes (B, max_boxes,
    4) xyxy, classes (B, max_boxes), scores (B, max_boxes), valid (B,
    max_boxes) bool), on the heads' device. ``scales``: each head's
    ``scale_x_y`` (``ops/decode.py``), or None: 1 for every head."""
    anchors_table = torch.as_tensor(anchors_table, dtype=torch.float32,
                                    device=outputs[0].device)
    xy_l, wh_l, obj_l, cls_l, offsets, grid_dims, anchors = _flatten_head_fields(
        outputs, anchors_table)

    best_cls_logit = torch.amax(cls_l, dim=-1)
    classes = torch.argmax(cls_l, dim=-1)  # first index among ties, as jnp.argmax
    scores = torch.sigmoid(obj_l) * torch.sigmoid(best_cls_logit)

    k = min(num_candidates, scores.shape[1])
    order = torch.argsort(-scores, dim=1, stable=True)[:, :k]
    cand_scores = torch.gather(scores, 1, order)

    def take(t):  # (B, N, 2) per-anchor fields → the candidates'
        return torch.gather(t, 1, order[..., None].expand(-1, -1, t.shape[-1]))

    # decode boxes for candidates only
    xy = torch.sigmoid(take(xy_l))
    if scales is not None and any(s != 1.0 for s in scales):
        per_anchor = torch.cat([torch.full((o.shape[1] * o.shape[2] * o.shape[3], 1), float(s),
                                           device=order.device) for o, s in zip(outputs, scales)])
        s = per_anchor[order]
        xy = xy * s - (s - 1.0) / 2.0
    center = (xy + offsets[order]) / grid_dims[order]
    size = torch.exp(take(wh_l)) * anchors[order]
    boxes = torch.cat([center - size / 2, center + size / 2], dim=-1)
    valid = cand_scores > torch.tensor(score_threshold, dtype=torch.float32)
    suppress = _pairwise_iou(boxes) > torch.tensor(iou_threshold, dtype=torch.float32)
    keep = suppression_sweep(suppress, valid)
    positions = torch.arange(k, device=order.device).expand(order.shape[0], k)
    sel_local, nvalid = _compact(positions, keep, max_boxes)
    sel_local = sel_local.long()
    det_boxes = torch.gather(boxes, 1, sel_local[..., None].expand(-1, -1, 4))
    det_scores = torch.gather(cand_scores, 1, sel_local)
    det_classes = torch.gather(torch.gather(classes, 1, order), 1, sel_local)
    vmask = torch.arange(max_boxes, device=order.device)[None, :] < nvalid[:, None]
    return det_boxes, det_classes, det_scores, vmask
