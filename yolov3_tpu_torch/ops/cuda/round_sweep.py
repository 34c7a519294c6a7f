"""K2 — full greedy NMS at K = N (round sweep): CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``yolov3_tpu/ops/pallas/round_sweep.py``
(``pallas_round_sweep`` / ``_kernel``), whose oracle is
``yolov3_tpu/ops/nms.py::_round_sweep_direct``: ``max_boxes`` rounds of
pick-the-highest-live-score (first index among ties == TF's stable sort),
emit its index, kill every live box with IoU > threshold; validity is
``score > score_threshold``. Output: sel (B, max_boxes) int32 original
indices in selection order, zero-padded, and num_valid (B,) int32.

The kernel (``csrc/round_sweep.cu``) runs a thread-block cluster per image:
each block holds its share of the boxes, their areas and live scores in its
own shared memory, a round folds the blocks' winners over distributed shared
memory behind one cluster barrier, and each block kills from its own memory.
``plan`` mirrors the launch's shape. Its note says what bounds it (the
dependent rounds) and why its IoU rounds exactly as ``round_sweep_ref`` does.
The kernel is reached only through the ``yolov3_torch::round_sweep`` op
(CPU kernel: the plain version; see ``nms_kernel.py``).
"""

from __future__ import annotations

import functools

import torch

from . import build

_SMS = 132                 # H100 SXM
_MAX_SMEM = 232448         # bytes of shared memory a block may use on sm_90
_MAX_CLUSTER = 16          # blocks a cluster may hold (above 8: non-portable)
BOX_BYTES = 24             # a box in shared memory: float4, area, live score
PER_BLOCK = (_MAX_SMEM - 1024) // BOX_BYTES
# the cluster's shared-memory capacity: beyond it the wrapper raises
MAX_N = _MAX_CLUSTER * PER_BLOCK


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, sms: int = _SMS):
    """What ``round_sweep_launch`` is given for B images of N boxes:
    ``dict(cluster, share, threads, smem, grid)``. The cluster is the largest
    power of two up to 16 that keeps B · cluster within the card's SMs (so
    B = 1 and 4 fill the card as B = 16 does), and at least what the boxes
    need in shared memory; a block holds ``share`` boxes, about three a
    thread (128 to 512 threads: fewer threads make the kill pass longer,
    more make the block's barrier and warp fold longer)."""
    if n > MAX_N:
        raise ValueError(f"round_sweep: N={n} exceeds the cluster's shared-memory bound {MAX_N}")
    need = -(-n // PER_BLOCK)
    cluster = 1
    while cluster < _MAX_CLUSTER and (b * cluster * 2 <= sms or cluster < need):
        cluster *= 2
    share = max(1, -(-n // cluster))
    threads = min(512, max(128, -(-share // 96) * 32))
    return dict(cluster=cluster, share=share, threads=threads, smem=share * BOX_BYTES,
                grid=b * cluster)


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
    """(sel (B, max_boxes) int32, num_valid (B,) int32), through the
    ``yolov3_torch::round_sweep`` op: CPU tensors take the plain version;
    CUDA tensors launch ``round_sweep_kernel`` (counted in
    ``round_sweep.launches``) or raise."""
    return torch.ops.yolov3_torch.round_sweep.default(
        bboxes, scores, float(iou_threshold), float(score_threshold), int(max_boxes))


round_sweep.launches = 0


@torch.library.custom_op("yolov3_torch::round_sweep", mutates_args=(), device_types="cpu")
def _round_sweep_op(bboxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                    score_threshold: float, max_boxes: int) -> tuple[torch.Tensor, torch.Tensor]:
    return round_sweep_ref(bboxes, scores, iou_threshold, score_threshold, max_boxes)


@_round_sweep_op.register_kernel("cuda")
def _round_sweep_cuda(bboxes, scores, iou_threshold, score_threshold, max_boxes):
    b, n, four = bboxes.shape
    if four != 4 or tuple(scores.shape) != (b, n) or scores.device != bboxes.device:
        raise ValueError(f"round_sweep: shapes {tuple(bboxes.shape)}, {tuple(scores.shape)}")
    pl = plan(b, n)
    boxes = bboxes.to(torch.float32).contiguous()
    if boxes.data_ptr() % 16:  # float4 loads
        boxes = boxes.clone()
    sc = scores.to(torch.float32).contiguous()
    sel = torch.empty((b, max_boxes), dtype=torch.int32, device=boxes.device)
    nv = torch.empty((b,), dtype=torch.int32, device=boxes.device)
    build.launch(build.function("round_sweep", "round_sweep_launch"), boxes.device,
                 "round_sweep", boxes.data_ptr(), sc.data_ptr(), sel.data_ptr(), nv.data_ptr(),
                 b, n, max_boxes, pl["cluster"], pl["share"], pl["threads"],
                 float(iou_threshold), float(score_threshold))
    round_sweep.launches += 1
    return sel, nv


@_round_sweep_op.register_fake
def _round_sweep_fake(bboxes, scores, iou_threshold, score_threshold, max_boxes):
    b = bboxes.shape[0]
    return (bboxes.new_empty((b, max_boxes), dtype=torch.int32),
            bboxes.new_empty((b,), dtype=torch.int32))
