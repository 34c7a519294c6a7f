"""Detection evaluation: per-class tp/fp/fn counters + AP@0.5.

Counterpart of ``yolov3_tpu/eval/detections_evaluator.py``, with the same
counter semantics (the reference's evaluate_detections.py):
  * per-pred best gt = argmax IoU (first index among ties, calc_iou :124-135);
  * a detection counts as TP iff IoU > thresh ∧ class match ∧ the selected
    gt was not already assigned *at decision time* — decided against the
    initial all-False assignment mask (:104-109), so several preds matching
    one gt in the same image all count TP (documented quirk);
  * fn = gts never assigned (:66-67); per-class counters (:56-80); negative
    gt class ids ⇒ the image only bumps 'errors' (:64-72 early return);
  * per-image histograms for preds/gts/tp/fp/fn.

The matcher is batched torch on whatever device its inputs live on: one
(B, P, G) IoU tensor, ``argmax`` and ``scatter_add_``, no loop over images.
The IoU takes the JAX package's float32 operations in the same order, so
``max_iou > iou_thresh`` decides alike. ``APAccumulator`` and
``CocoAPAccumulator`` (mAP@0.5 and mAP@[.5:.95], an extension of the
reference) are the JAX package's float64 numpy code, copied.
"""

from __future__ import annotations

import numpy as np
import torch


def _pairwise_iou(a, b):
    """a: (B, P, 4), b: (B, G, 4) xyxy → (B, P, G).

    The reference evaluator's math (evaluate_detections.py:38-48): no
    negative-extent clamping on areas, unlike ``ops/nms.py``'s IoU. A NaN box
    makes ``union > 0`` false, so its IoU is 0."""
    lt = torch.maximum(a[:, :, None, :2], b[:, None, :, :2])
    rb = torch.minimum(a[:, :, None, 2:], b[:, None, :, 2:])
    wh = torch.maximum(rb - lt, torch.zeros((), dtype=a.dtype, device=a.device))
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[:, :, None] + area_b[:, None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def evaluate_image_counters(pred_boxes, pred_classes, pred_valid,
                            gt_boxes, gt_classes, gt_valid, nclasses: int, iou_thresh):
    """Batched counters on the inputs' device. Args have a leading batch dim
    (pred_boxes (B, P, 4) f32, pred_classes (B, P) int, pred_valid (B, P)
    bool, gt_* likewise over G); returns per-image counters, int32 tensors
    (B, nclasses) for tp/fp/fn/gts/preds and (B,) for errors/examples."""
    b, p = pred_classes.shape
    iou = _pairwise_iou(pred_boxes, gt_boxes)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))  # never a padded gt
    best_gt = torch.argmax(iou, dim=-1)  # first index among ties, as jnp.argmax
    max_iou = torch.amax(iou, dim=-1)

    sel_class = torch.gather(gt_classes, 1, best_gt)
    thresh = torch.tensor(iou_thresh, dtype=torch.float32, device=iou.device)
    decisions = pred_valid & (max_iou > thresh) & (sel_class == pred_classes)

    assigned = torch.zeros(gt_valid.shape, dtype=torch.int32, device=iou.device)
    assigned = assigned.scatter_add_(1, best_gt, decisions.to(torch.int32)) > 0
    assigned = assigned & gt_valid

    error = torch.any(gt_valid & (gt_classes < 0), dim=1)

    pc = torch.clamp(pred_classes, 0, nclasses - 1).long()
    gc = torch.clamp(gt_classes, 0, nclasses - 1).long()

    def count(idx, mask):
        out = torch.zeros((b, nclasses), dtype=torch.int32, device=iou.device)
        return out.scatter_add_(1, idx, mask.to(torch.int32))

    counters = {
        "tp": count(pc, decisions),
        "fp": count(pc, pred_valid & ~decisions),
        "fn": count(gc, gt_valid & ~assigned),
        "gts": count(gc, gt_valid),
        "preds": count(pc, pred_valid),
    }
    # error sample: only 'errors' increments (reference :64-72 early return)
    counters = {k: torch.where(error[:, None], torch.zeros_like(v), v)
                for k, v in counters.items()}
    counters["errors"] = error.to(torch.int32)
    counters["examples"] = 1 - error.to(torch.int32)
    return counters


class EvaluateDetections:
    """Accumulating evaluator with the reference's surface: per-class
    counters dict + per-image histograms. ``evaluate_batch`` matches on the
    device of the tensors it is given (numpy arrays: the CPU)."""

    def __init__(self, nclasses: int, iou_thresh: float = 0.5):
        self.nclasses = nclasses
        self.iou_thresh = iou_thresh
        zeros = np.zeros(nclasses, np.int64)
        self.counters = {
            "preds": zeros.copy(), "gts": zeros.copy(),
            "tp": zeros.copy(), "fp": zeros.copy(), "fn": zeros.copy(),
            "errors": 0, "examples": 0,
        }
        self.preds_histo, self.gt_histo = [], []
        self.tp_histo, self.fp_histo, self.fn_histo = [], [], []

    def evaluate_batch(self, pred_boxes, pred_classes, pred_valid,
                       gt_boxes, gt_classes, gt_valid):
        device = pred_boxes.device if torch.is_tensor(pred_boxes) else torch.device("cpu")

        def on(x, dtype):
            return torch.as_tensor(x, device=device).to(dtype)

        out = evaluate_image_counters(
            on(pred_boxes, torch.float32), on(pred_classes, torch.int32),
            on(pred_valid, torch.bool), on(gt_boxes, torch.float32),
            on(gt_classes, torch.int32), on(gt_valid, torch.bool),
            self.nclasses, self.iou_thresh)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        nimg = out["tp"].shape[0]
        for i in range(nimg):
            self.preds_histo.append(out["preds"][i])
            self.gt_histo.append(out["gts"][i])
            self.tp_histo.append(out["tp"][i])
            self.fp_histo.append(out["fp"][i])
            self.fn_histo.append(out["fn"][i])
        for key in ("preds", "gts", "tp", "fp", "fn"):
            self.counters[key] = self.counters[key] + out[key].sum(axis=0)
        self.counters["errors"] += int(out["errors"].sum())
        self.counters["examples"] += int(out["examples"].sum())
        return self.counters

    def recall_precision(self):
        tp = self.counters["tp"].astype(np.float64)
        recall = tp / (tp + self.counters["fn"] + 1e-20)
        precision = tp / (tp + self.counters["fp"] + 1e-20)
        return recall, precision


# ---------------------------------------------------------------------------
# mAP@0.5 (extension)
# ---------------------------------------------------------------------------


class APAccumulator:
    """Collects score-ranked detections over a dataset, computes AP@0.5."""

    def __init__(self, nclasses: int, iou_thresh: float = 0.5):
        self.nclasses = nclasses
        self.iou_thresh = iou_thresh
        self.records = [[] for _ in range(nclasses)]  # (score, is_tp)
        self.n_gt = np.zeros(nclasses, np.int64)

    def add_image(self, pred_boxes, pred_classes, pred_scores, gt_boxes, gt_classes):
        """Standard greedy matching by descending score, per class."""
        pred_boxes = np.asarray(pred_boxes, np.float64)
        gt_boxes = np.asarray(gt_boxes, np.float64)
        pred_classes = np.asarray(pred_classes, np.int64)
        gt_classes = np.asarray(gt_classes, np.int64)
        pred_scores = np.asarray(pred_scores, np.float64)
        for c in np.unique(gt_classes):
            if 0 <= c < self.nclasses:
                self.n_gt[c] += int((gt_classes == c).sum())
        order = np.argsort(-pred_scores)
        taken = np.zeros(len(gt_boxes), bool)
        for i in order:
            c = pred_classes[i]
            if not (0 <= c < self.nclasses):
                continue
            cand = np.where((gt_classes == c) & ~taken)[0]
            is_tp = False
            if len(cand):
                ious = _np_iou_one(pred_boxes[i], gt_boxes[cand])
                j = int(np.argmax(ious))
                if ious[j] > self.iou_thresh:
                    taken[cand[j]] = True
                    is_tp = True
            self.records[c].append((pred_scores[i], is_tp))

    def compute(self):
        aps = np.full(self.nclasses, np.nan)
        for c in range(self.nclasses):
            if self.n_gt[c] == 0:
                continue
            recs = sorted(self.records[c], key=lambda r: -r[0])
            tps = np.array([r[1] for r in recs], np.float64)
            if len(tps) == 0:
                aps[c] = 0.0
                continue
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(1.0 - tps)
            recall = tp_cum / self.n_gt[c]
            precision = tp_cum / (tp_cum + fp_cum)
            # precision envelope + integrate (continuous VOC-style)
            mrec = np.concatenate([[0.0], recall, [recall[-1]]])
            mpre = np.concatenate([[1.0], precision, [0.0]])
            for i in range(len(mpre) - 2, -1, -1):
                mpre[i] = max(mpre[i], mpre[i + 1])
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            aps[c] = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
        mean_ap = float(np.nanmean(aps)) if np.any(~np.isnan(aps)) else 0.0
        return aps, mean_ap


def _np_iou_one(box, boxes):
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[:, 0] * wh[:, 1]
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area + areas - inter
    return np.where(union > 0, inter / union, 0.0)


def average_precision_50(acc: APAccumulator):
    return acc.compute()


class CocoAPAccumulator:
    """COCO-style AP@[.5:.95] — ten IoU thresholds, averaged (extension;
    the reference computes no AP at all)."""

    def __init__(self, nclasses: int):
        self.thresholds = [0.5 + 0.05 * i for i in range(10)]
        self.accs = [APAccumulator(nclasses, t) for t in self.thresholds]

    def add_image(self, pred_boxes, pred_classes, pred_scores, gt_boxes, gt_classes):
        for acc in self.accs:
            acc.add_image(pred_boxes, pred_classes, pred_scores, gt_boxes, gt_classes)

    def compute(self):
        """Returns (ap_per_class (nclasses,), mAP@[.5:.95], mAP@0.5)."""
        per_thr = [acc.compute() for acc in self.accs]
        aps = np.nanmean(np.stack([aps for aps, _ in per_thr]), axis=0)
        map5095 = float(np.nanmean([m for _, m in per_thr]))
        return aps, map5095, per_thr[0][1]
