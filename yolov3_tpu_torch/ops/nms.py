"""Fixed-shape, batched, class-agnostic NMS.

Counterpart of ``yolov3_tpu/ops/nms.py`` with the same semantics (the
reference's core/yolo_nms.py:15-34, i.e. TF's
``non_max_suppression_padded`` with ``pad_to_max_output_size``): best class
= argmax of class probs, score = objectness × max class prob, greedy
class-agnostic suppression (per-class as an opt-in), padded outputs
``(bboxes, class_indices, scores, selected_indices, num_valid)``.

Branches, in the JAX package's order:
  * K = N > ``_MATRIX_SWEEP_MAX_K``: the round sweep directly on the
    unsorted boxes (argmax's first-index tie-break == TF's stable sort);
  * K > ``_MATRIX_SWEEP_MAX_K``: the round sweep over the top-K sorted
    candidates, positions mapped back to original indices;
  * otherwise: a (B, K, K) IoU > threshold matrix and the suppression sweep.

The device decides the sweep: on a CUDA tensor the hand-written kernels
(``ops/cuda/``) run, on a CPU tensor their plain PyTorch versions.
"""

from __future__ import annotations

import os

import torch

from .cuda.nms_kernel import suppression_sweep
from .cuda.round_sweep import round_sweep

DEFAULT_NUM_CANDIDATES = 512
# above this K the (B, K, K) suppression matrix (pairwise IoU, then K1) gives
# way to the round sweep (K2) on the top K. Set for the serving bucket B=16
# on an H100 (700 W, kernel_times.py nms): there the round sweep took less
# device time from K = 1,024 on (0.44 against 1.06 ms) and about the same at
# 512 (0.44 against 0.46), and less host time at every K measured. K1 takes
# K <= 1,300 (ops/cuda/nms_kernel.py); the JAX package's TPU bound was 4,096.
# YOLOV3_NMS_MATRIX_MAX_K overrides it, as in the JAX package; on the card a
# matrix branch above K1's 1,300 raises when K1 is called.
_MATRIX_SWEEP_MAX_K = int(os.environ.get("YOLOV3_NMS_MATRIX_MAX_K", 512))


def _pairwise_iou(boxes):
    """boxes: (B, K, 4) xyxy → (B, K, K) IoU."""
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))
    union = area[:, :, None] + area[:, None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _candidates(boxes, scores, k: int):
    """Stable top-K by descending score (TF tie-break: lower index first)."""
    order = torch.argsort(-scores, dim=1, stable=True)[:, :k]
    cand_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).float()
    return order, cand_boxes, torch.gather(scores, 1, order).float()


def _compact(order, keep, max_boxes: int):
    """Kept candidates (already score-ordered) → padded selected indices.
    Out-of-range ranks land in slot ``max_boxes`` of a ``max_boxes+1``
    buffer, which is dropped."""
    rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    num_valid = torch.clamp(keep.sum(dim=1), max=max_boxes).to(torch.int32)
    write_pos = torch.where(keep & (rank < max_boxes), rank,
                            torch.full_like(rank, max_boxes)).long()
    padded = torch.zeros((order.shape[0], max_boxes + 1), dtype=torch.int32,
                         device=order.device)
    padded.scatter_(1, write_pos, order.to(torch.int32))
    return padded[:, :max_boxes], num_valid


def yolo_nms(bboxes, confidence, class_probs, max_boxes: int = 100,
             iou_threshold: float = 0.5, score_threshold: float = 0.1,
             num_candidates: int = DEFAULT_NUM_CANDIDATES, per_class: bool = False):
    """Batched NMS. bboxes (B, N, 4) xyxy; confidence (B, N, 1); class_probs
    (B, N, nc). ``per_class`` suppresses only among boxes of the same argmax
    class by offsetting the SWEEP boxes by ``class·4`` (decoded boxes stay
    within (-1, 2), so cross-class IoU is exactly 0); outputs keep the
    unshifted boxes.

    Exact vs TF's full NMS whenever the top-``num_candidates`` truncation
    cannot change the outcome; ``yolo_nms_exact`` escalates K until it
    provably cannot.

    Returns bboxes (B, N, 4), class_indices (B, N), scores (B, N),
    selected_indices (B, max_boxes) int32, num_valid (B,) int32.
    """
    class_indices = torch.argmax(class_probs, dim=-1)  # first index among ties
    best_prob = torch.amax(class_probs, dim=-1)
    scores = confidence[..., 0] * best_prob

    sweep_bboxes = bboxes
    if per_class:
        sweep_bboxes = bboxes + class_indices[..., None].to(torch.float32) * 4.0

    n = scores.shape[1]
    k = min(num_candidates, n)

    if k >= n and k > _MATRIX_SWEEP_MAX_K:
        sel, nvalid = round_sweep(sweep_bboxes, scores, iou_threshold, score_threshold,
                                  max_boxes=max_boxes)
        return bboxes, class_indices, scores, sel, nvalid

    order, cand_boxes, cand_scores = _candidates(sweep_bboxes, scores, k)

    if k > _MATRIX_SWEEP_MAX_K:
        # validity on sorted candidates is the same score > threshold test
        sel_pos, nvalid = round_sweep(cand_boxes, cand_scores, iou_threshold,
                                      score_threshold, max_boxes=max_boxes)
        slots = torch.arange(max_boxes, device=order.device)[None, :]
        mapped = torch.gather(order, 1, sel_pos.long()).to(torch.int32)
        sel = torch.where(slots < nvalid[:, None], mapped, torch.zeros_like(mapped))
        return bboxes, class_indices, scores, sel, nvalid

    valid = cand_scores > torch.tensor(score_threshold, dtype=torch.float32)
    suppress_mat = _pairwise_iou(cand_boxes) > torch.tensor(iou_threshold,
                                                            dtype=torch.float32)
    keep = suppression_sweep(suppress_mat, valid)
    sel, nvalid = _compact(order, keep, max_boxes)
    return bboxes, class_indices, scores, sel, nvalid


def nms_inexact_mask(scores, num_valid, max_boxes: int, score_threshold: float, k: int):
    """Per-image bool tensor: True where top-K truncation MAY have changed the
    result — fewer than ``max_boxes`` kept within the top-K AND candidates
    beyond rank K still beat the threshold (lower-scored boxes never
    suppress higher-scored ones)."""
    above = (scores > torch.tensor(score_threshold, dtype=torch.float32)).sum(dim=1)
    return (num_valid < max_boxes) & (above > k)


def next_escalation_k(k: int, n: int, device) -> int:
    """Next top-K bucket when truncation at ``k`` could have diverged. On the
    card, when K = N lands on the round-sweep kernel (n > the matrix bound),
    jump straight to exactness; else keep doubling. Measured on an H100 (700
    W) at B=16, N=10,647 from K=64 (kernel_times.py nms, chip_smoke.py phase
    5): the jump took 1.1–2.4 ms, doubling 1.9–7.6 (two to four rounds of a
    top-K sort and a sweep before one of them is exact)."""
    if torch.device(device).type == "cuda" and n > _MATRIX_SWEEP_MAX_K:
        return n
    return min(n, k * 2)


def yolo_nms_exact(bboxes, confidence, class_probs, max_boxes: int = 100,
                   iou_threshold: float = 0.5, score_threshold: float = 0.1,
                   num_candidates: int = DEFAULT_NUM_CANDIDATES):
    """Host-side escalation loop guaranteeing index-exact parity with TF's FULL NMS:
    reruns ``yolo_nms`` with a larger K while ``nms_inexact_mask`` says the
    truncation could have altered any image's result, up to K = N."""
    n = bboxes.shape[1]
    k = min(num_candidates, n)
    while True:
        out = yolo_nms(bboxes, confidence, class_probs, max_boxes=max_boxes,
                       iou_threshold=iou_threshold, score_threshold=score_threshold,
                       num_candidates=k)
        if k >= n:
            return out
        _, _, scores, _, nvalid = out
        if not bool(nms_inexact_mask(scores, nvalid, max_boxes, score_threshold, k).any()):
            return out
        k = next_escalation_k(k, n, bboxes.device)


def gather_detections(bboxes, class_indices, scores, selected, num_valid):
    """Compact (B, max_boxes) detections from padded NMS output, on device.
    Returns (boxes, classes, scores, valid_mask)."""
    idx = selected.long()
    boxes = torch.gather(bboxes, 1, idx[..., None].expand(-1, -1, 4))
    classes = torch.gather(class_indices, 1, idx)
    det_scores = torch.gather(scores, 1, idx)
    valid = torch.arange(selected.shape[1], device=selected.device)[None, :] < num_valid[:, None]
    return boxes, classes, det_scores, valid
