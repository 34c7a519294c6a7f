"""YOLO head decoding: raw grid logits → (boxes, confidence, class probs).

Counterpart of ``yolov3_tpu/ops/decode.py`` (reference
core/yolo_decode_layer.py:15-36): sigmoid on xy / objectness / class
logits; centre = (sigmoid(xy) + cell offset) / grid size; wh =
exp(wh logits) · anchor (``anchors_table[i]`` pairs with head output i,
13-grid first); boxes flattened per scale and concatenated in head order,
corner format (xmin, ymin, xmax, ymax). Computed in float32.
"""

from __future__ import annotations

import torch


def yolo_decode(model_output_grids, anchors_table, nclasses: int):
    """Decode all scales.

    Args:
      model_output_grids: list of (B, g, g, 3, 5+nc) raw head outputs.
      anchors_table: (nscales, 3, 2) normalized (w, h), array or tensor.
      nclasses: number of classes.

    Returns:
      bboxes (B, N, 4) xyxy; confidence (B, N, 1); class_probs (B, N, nc),
      N = Σ g*g*3 across scales.
    """
    all_boxes, all_conf, all_probs = [], [], []
    device = model_output_grids[0].device
    anchors_table = torch.as_tensor(anchors_table, dtype=torch.float32, device=device)
    for grid_out, anchors in zip(model_output_grids, anchors_table):
        b, gh, gw, _, _ = grid_out.shape
        g = grid_out.float()
        xy = torch.sigmoid(g[..., 0:2])
        wh_l = g[..., 2:4]
        conf = torch.sigmoid(g[..., 4:5])
        probs = torch.sigmoid(g[..., 5:])

        # cell offsets: grid[i, j] = (x=j, y=i), like tf.meshgrid(range, range)
        row, col = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=device),
                                  torch.arange(gw, dtype=torch.float32, device=device),
                                  indexing="ij")
        offsets = torch.stack([col, row], dim=-1)[None, :, :, None, :]  # (1,g,g,1,2)

        # (gw, gh) computed on the device, exactly: a tensor from a Python
        # list, or an item set from one, is a copy the host waits on
        grid_dims = torch.arange(2, dtype=torch.float32, device=device) * (gh - gw) + gw
        center = (xy + offsets) / grid_dims
        wh = torch.exp(wh_l) * anchors
        boxes = torch.cat([center - wh / 2.0, center + wh / 2.0], dim=-1)

        all_boxes.append(boxes.reshape(b, -1, 4))
        all_conf.append(conf.reshape(b, -1, 1))
        all_probs.append(probs.reshape(b, -1, nclasses))

    return torch.cat(all_boxes, 1), torch.cat(all_conf, 1), torch.cat(all_probs, 1)
