"""Grid-scatter target assignment — fixed shapes, on the device.

Counterpart of ``yolov3_tpu/ops/assign.py``, bit for bit:

  * best anchor per box = the first argmax of width/height-only IoU against
    all anchors flattened; anchor-within-scale = best % 3, owning scale =
    best // 3;
  * cell = trunc(center_xy · grid) as int32, clipped to [0, grid−1] (a box
    centre at exactly 1.0 lands in the last cell), scattered at
    [batch, row, col, anchor] with the raw label row
    [xmin, ymin, xmax, ymax, obj, cls];
  * boxes another scale owns, or with obj == 0, go to a dump slot that is
    sliced away: no boolean indexing, no data-dependent shapes;
  * when two boxes land on one (cell, anchor) slot the highest label index
    wins: a scatter-``amax`` of the box order, then a gather. An indexed
    assignment with duplicate indices would leave the winner undefined on
    CUDA.
"""

from __future__ import annotations

import torch


def best_anchor_indices(labels, anchors_table):
    """Width/height-only IoU argmax over all anchors.

    labels: (..., M, 6) rows [xmin, ymin, xmax, ymax, obj, cls].
    anchors_table: (S, 3, 2) → flattened to (S·3, 2).
    Returns (..., M) int32 in [0, S·3). A padded all-zero row has IoU 0
    against every anchor (0 / anchor_area) and takes anchor 0.
    """
    anchors = torch.as_tensor(anchors_table, dtype=torch.float32,
                              device=labels.device).reshape(-1, 2)
    anchor_area = anchors[:, 0] * anchors[:, 1]
    box_wh = (labels[..., 2:4] - labels[..., 0:2])[..., None, :]  # (..., M, 1, 2)
    box_area = box_wh[..., 0] * box_wh[..., 1]
    inter = (torch.minimum(box_wh[..., 0], anchors[:, 0])
             * torch.minimum(box_wh[..., 1], anchors[:, 1]))
    iou = inter / (box_area + anchor_area - inter)
    # the FIRST maximum, as jnp.argmax: the lowest index that reaches the max
    is_max = iou == iou.max(dim=-1, keepdim=True).values
    index = torch.arange(anchors.shape[0], dtype=torch.int32, device=labels.device)
    return torch.where(is_max, index, anchors.shape[0]).min(dim=-1).values.to(torch.int32)


def assign_targets(labels, anchors_table, grid_sizes):
    """Scatter padded label rows into per-scale dense target cubes.

    labels: (B, M, 6) float — padded rows are all-zero (obj == 0).
    anchors_table: (S, 3, 2) normalized anchors, scale 0 ↔ 13-grid head.
    grid_sizes: sequence of S grid sizes, model output order.
    Returns a tuple of S tensors (B, g, g, 3, 6) on ``labels.device``.
    """
    labels = labels.to(torch.float32)
    b, m, f = labels.shape
    dev = labels.device
    best = best_anchor_indices(labels, anchors_table).to(torch.int64)  # (B, M)
    anchor_in_scale = best % 3
    owner_scale = best // 3
    obj_ok = labels[..., 4] != 0

    center = (labels[..., 0:2] + labels[..., 2:4]) / 2.0  # (B, M, 2) as (x, y)
    batch_idx = torch.arange(b, device=dev)[:, None].expand(b, m)
    order = torch.arange(b * m, device=dev)
    flat_labels = labels.reshape(-1, f)

    grids = []
    for s, g in enumerate(grid_sizes):
        g = int(g)
        row = torch.clamp((center[..., 1] * g).to(torch.int32), 0, g - 1).to(torch.int64)
        col = torch.clamp((center[..., 0] * g).to(torch.int32), 0, g - 1).to(torch.int64)
        valid = obj_ok & (owner_scale == s)
        dump = b * g * g * 3  # one-past-the-end slot for masked boxes
        flat_idx = ((batch_idx * g + row) * g + col) * 3 + anchor_in_scale
        flat_idx = torch.where(valid, flat_idx, torch.full_like(flat_idx, dump)).reshape(-1)
        winner = torch.full((dump + 1,), -1, dtype=torch.int64, device=dev)
        winner = winner.scatter_reduce(0, flat_idx, order, reduce="amax", include_self=True)
        rows = torch.where((winner >= 0)[:, None], flat_labels[winner.clamp(min=0)],
                           torch.zeros((), dtype=labels.dtype, device=dev))
        grids.append(rows[:-1].reshape(b, g, g, 3, f))
    return tuple(grids)
