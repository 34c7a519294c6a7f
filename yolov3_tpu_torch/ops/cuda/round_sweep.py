"""K2 — full greedy NMS at K = N (round sweep): CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``yolov3_tpu/ops/pallas/round_sweep.py``
(``pallas_round_sweep`` / ``_kernel``), whose oracle is
``yolov3_tpu/ops/nms.py::_round_sweep_direct``: ``max_boxes`` rounds of
pick-the-highest-live-score (first index among ties == TF's stable sort),
emit its index, kill every live box with IoU > threshold; validity is
``score > score_threshold``. Output: sel (B, max_boxes) int32 original
indices in selection order, zero-padded, and num_valid (B,) int32.

The kernel (``csrc/round_sweep.cu``) runs one 1024-thread block per image
with the live scores in shared memory (raised past 48 KB with
``cudaFuncAttributeMaxDynamicSharedMemorySize``) and the boxes read from
global memory through L2. Its note says what bounds it (the dependent
rounds) and why its IoU rounds exactly as ``round_sweep_ref`` does.
"""

from __future__ import annotations

import torch

from . import build

# live scores in shared memory: N floats within the 227 KB a block may use
MAX_N = (227 * 1024 - 1024) // 4


def _iou_one_vs_all(box, boxes):
    """box (B, 4) vs boxes (B, N, 4) → (B, N) IoU, in the operation order
    of ``yolov3_tpu/ops/nms.py::_iou_one_vs_all``."""
    lt = torch.maximum(box[:, None, :2], boxes[..., :2])
    rb = torch.minimum(box[:, None, 2:], boxes[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))
    area_b = (torch.clamp(box[:, 2] - box[:, 0], min=0.0)
              * torch.clamp(box[:, 3] - box[:, 1], min=0.0))
    union = area_b[:, None] + area - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def round_sweep_ref(bboxes, scores, iou_threshold, score_threshold, max_boxes: int = 100):
    """Plain PyTorch version (mirrors ``nms.py::_round_sweep_direct``,
    batched). bboxes (B, N, 4), scores (B, N) → (sel, num_valid)."""
    boxes = bboxes.float()
    scores = scores.float()
    b = scores.shape[0]
    neg = torch.tensor(float("-inf"), device=scores.device)
    live = scores > torch.tensor(score_threshold, dtype=torch.float32)
    iou_thr = torch.tensor(iou_threshold, dtype=torch.float32)
    rows = torch.arange(b, device=scores.device)
    sel = torch.zeros((b, max_boxes), dtype=torch.int32, device=scores.device)
    nv = torch.zeros((b,), dtype=torch.int32, device=scores.device)
    for i in range(max_boxes):
        masked = torch.where(live, scores, neg)
        j = torch.argmax(masked, dim=1)
        found = masked[rows, j] > neg
        sel[:, i] = torch.where(found, j, 0).to(torch.int32)
        nv += found.to(torch.int32)
        iou = _iou_one_vs_all(boxes[rows, j], boxes)
        live = live & ~((iou > iou_thr.to(iou.device)) & found[:, None])
        live[rows, j] = False
    return sel, nv


def round_sweep(bboxes, scores, iou_threshold, score_threshold, max_boxes: int = 100):
    """(sel (B, max_boxes) int32, num_valid (B,) int32). CPU tensors take the
    plain version; CUDA tensors launch ``round_sweep_kernel`` (counted in
    ``round_sweep.launches``) or raise."""
    if bboxes.device.type == "cpu":
        return round_sweep_ref(bboxes, scores, iou_threshold, score_threshold, max_boxes)
    if bboxes.device.type != "cuda":
        raise ValueError(f"round_sweep: unsupported device {bboxes.device}")
    b, n, four = bboxes.shape
    if four != 4 or tuple(scores.shape) != (b, n) or scores.device != bboxes.device:
        raise ValueError(f"round_sweep: shapes {tuple(bboxes.shape)}, {tuple(scores.shape)}")
    if n > MAX_N:
        raise ValueError(f"round_sweep: N={n} exceeds the shared-memory bound {MAX_N}")
    boxes = bboxes.to(torch.float32).contiguous()
    if boxes.data_ptr() % 16:  # float4 loads
        boxes = boxes.clone()
    sc = scores.to(torch.float32).contiguous()
    sel = torch.empty((b, max_boxes), dtype=torch.int32, device=boxes.device)
    nv = torch.empty((b,), dtype=torch.int32, device=boxes.device)
    build.launch(build.function("round_sweep", "round_sweep_launch"), boxes.device,
                 "round_sweep", boxes.data_ptr(), sc.data_ptr(), sel.data_ptr(), nv.data_ptr(),
                 b, n, max_boxes, float(iou_threshold), float(score_threshold))
    round_sweep.launches += 1
    return sel, nv


round_sweep.launches = 0
