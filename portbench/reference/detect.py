"""Decode, suppression and gather of YOLOv3 detections, in plain PyTorch.

  * decode (Redmon & Farhadi, arXiv:1804.02767, §2.1): centre =
    (sigmoid(t_xy) + cell) / grid, size = exp(t_wh) · anchor, corners
    (xmin, ymin, xmax, ymax); objectness and class probabilities are
    sigmoids; the score is objectness × the largest class probability, whose
    first index is the class;
  * suppression: TensorFlow's padded non-max suppression over the top K
    candidates by score (a stable sort: the lower index first among ties),
    class-agnostic: a candidate above the score threshold is kept unless a
    kept candidate before it overlaps it by an IoU above the threshold; the
    first ``max_boxes`` kept, by rank, are the selection;
  * gather: each selected candidate's box, class and score.

All in float32. The overlaps are computed by the same element-wise
expression as the port states it (intersection over the union of the two
areas, 0 where the union is 0), so that the suppression of a set of boxes
is decided exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def decode(heads, anchors, nclasses: int):
    """heads: (B, g, g, 3, 5 + nc) each; anchors (S, 3, 2) → boxes (B, N, 4),
    objectness (B, N), class probabilities (B, N, nc)."""
    boxes, conf, probs = [], [], []
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=heads[0].device)
    for out, anc in zip(heads, anchors):
        b, gh, gw = out.shape[:3]
        g = out.float()
        row, col = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=g.device),
                                  torch.arange(gw, dtype=torch.float32, device=g.device),
                                  indexing="ij")
        cells = torch.stack([col, row], dim=-1)[None, :, :, None, :]
        grid = torch.tensor([gw, gh], dtype=torch.float32, device=g.device)
        centre = (torch.sigmoid(g[..., 0:2]) + cells) / grid
        wh = torch.exp(g[..., 2:4]) * anc
        boxes.append(torch.cat([centre - wh / 2.0, centre + wh / 2.0], -1).reshape(b, -1, 4))
        conf.append(torch.sigmoid(g[..., 4]).reshape(b, -1))
        probs.append(torch.sigmoid(g[..., 5:]).reshape(b, -1, nclasses))
    return torch.cat(boxes, 1), torch.cat(conf, 1), torch.cat(probs, 1)


def scores_classes(conf, probs):
    best, cls = probs.max(dim=-1)
    return conf * best, cls


def pairwise_iou(boxes):
    """(B, K, 4) → (B, K, K) IoU."""
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))
    union = area[:, :, None] + area[:, None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms(boxes, scores, max_boxes: int, iou_threshold: float, score_threshold: float,
        candidates: int):
    """Greedy suppression → (selected (B, max_boxes) int64 padded with 0,
    num_valid (B,) int64)."""
    k = min(candidates, scores.shape[1])
    order = torch.argsort(-scores, dim=1, stable=True)[:, :k]
    cand = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid = (torch.gather(scores, 1, order)
             > torch.tensor(score_threshold, dtype=torch.float32, device=scores.device))
    over = (pairwise_iou(cand) > torch.tensor(iou_threshold, dtype=torch.float32,
                                              device=scores.device)).cpu().numpy()
    valid, order = valid.cpu().numpy(), order.cpu().numpy()
    selected = np.zeros((scores.shape[0], max_boxes), dtype=np.int64)
    num_valid = np.zeros(scores.shape[0], dtype=np.int64)
    for b in range(scores.shape[0]):
        suppressed = np.zeros(k, dtype=bool)
        kept = []
        for i in range(k):
            if not valid[b, i] or suppressed[i]:
                continue
            kept.append(i)
            suppressed |= over[b, i]
        n = min(len(kept), max_boxes)
        selected[b, :n] = order[b, kept[:n]]
        num_valid[b] = n
    return torch.from_numpy(selected), torch.from_numpy(num_valid)


def gather(boxes, classes, scores, selected, num_valid):
    """The selected detections: boxes (B, M, 4), classes (B, M), scores
    (B, M), valid (B, M)."""
    idx = selected.long()
    return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
            torch.gather(classes, 1, idx), torch.gather(scores, 1, idx),
            torch.arange(idx.shape[1], device=idx.device)[None, :] < num_valid[:, None])
