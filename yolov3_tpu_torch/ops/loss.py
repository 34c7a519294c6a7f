"""Composite 4-term YOLO loss — the reference's math, in f32 whatever the
head dtype.

Counterpart of ``yolov3_tpu/ops/loss.py`` (reference core/loss_func.py:19-69),
including its documented deviations from canonical YOLOv3:
  * objectness BCE over *all* cells — no noobj ignore-mask;
  * class loss = sparse categorical CE over *sigmoid'd* class probabilities,
    which Keras re-normalizes inside the CE:
    −log(softmax(log(clip(sigmoid(x)))));
  * xy/wh are obj-masked L2 with the 2 − w·h small-box upweight;
  * wh target = log(wh / anchors) with inf and NaN → 0.

Keras epsilon clipping (1e-7) in both CE terms is reproduced.
"""

from __future__ import annotations

import torch

KERAS_EPSILON = 1e-7


def _keras_clip(p):
    """``clip(p, ε, 1 − ε)`` as ``minimum(maximum(p, ε), 1 − ε)``: where a
    probability sits exactly on a bound the gradient is halved, as the JAX
    package's ``jnp.clip`` does (``torch.clamp`` would pass it whole)."""
    lo = torch.full((), KERAS_EPSILON, dtype=p.dtype, device=p.device)
    hi = torch.full((), 1.0 - KERAS_EPSILON, dtype=p.dtype, device=p.device)
    return torch.minimum(torch.maximum(p, lo), hi)


def yolo_loss_terms(y_true, y_pred, anchors, nclasses: int):
    """Per-scale loss terms.

    y_true: (B, g, g, 3, 6) grid targets — rows [xmin, ymin, xmax, ymax, obj, cls].
    y_pred: (B, g, g, 3, 5+nc) raw head logits.
    anchors: (3, 2) normalized anchors of this scale.
    Returns a (4,) f32 tensor [xy_loss, wh_loss, obj_loss, class_loss], sums
    over the whole batch (the caller divides by the batch size).
    """
    y_pred = y_pred.float()
    y_true = y_true.float()
    dev = y_pred.device
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)

    pred_xy = torch.sigmoid(y_pred[..., 0:2])
    pred_wh = y_pred[..., 2:4]
    pred_obj = torch.sigmoid(y_pred[..., 4:5])
    pred_class = torch.sigmoid(y_pred[..., 5:])

    true_box, true_obj, true_class_idx = y_true[..., 0:4], y_true[..., 4:5], y_true[..., 5:6]
    true_xy = (true_box[..., 0:2] + true_box[..., 2:4]) / 2.0
    true_wh = true_box[..., 2:4] - true_box[..., 0:2]

    # small-box upweight (loss_func.py:37)
    box_loss_scale = 2.0 - true_wh[..., 0] * true_wh[..., 1]

    g = y_true.shape[1]
    # tf.meshgrid(range(g), range(g)) stacked → grid[i, j] = (x=j, y=i)
    idx = torch.arange(g, dtype=torch.float32, device=dev)
    offsets = torch.stack([idx[None, :].expand(g, g), idx[:, None].expand(g, g)],
                          dim=-1)[None, :, :, None, :]
    true_xy = true_xy * g - offsets

    true_wh = torch.log(true_wh / anchors)
    # padded rows have wh = 0: log(0) = −inf → 0; a NaN (0/0) goes to 0 too
    true_wh = torch.where(torch.isinf(true_wh) | torch.isnan(true_wh),
                          torch.zeros_like(true_wh), true_wh)

    obj_mask = true_obj[..., 0]

    xy_loss = torch.sum(obj_mask * box_loss_scale
                        * torch.sum(torch.square(true_xy - pred_xy), dim=-1))
    wh_loss = torch.sum(obj_mask * box_loss_scale
                        * torch.sum(torch.square(true_wh - pred_wh), dim=-1))

    # Keras binary_crossentropy(from_logits=False): clip, then mean over the last axis
    p = _keras_clip(pred_obj)
    bce = -(true_obj * torch.log(p) + (1.0 - true_obj) * torch.log(1.0 - p))
    obj_loss = torch.sum(torch.mean(bce, dim=-1))

    # Keras sparse_categorical_crossentropy over probabilities:
    # logits := log(clip(p)); loss = logsumexp(logits) − logits[class], with the
    # manual max + log-sum-exp of the JAX package
    logp = torch.log(_keras_clip(pred_class))
    m = torch.max(logp, dim=-1, keepdim=True).values
    lse = (m + torch.log(torch.sum(torch.exp(logp - m), dim=-1, keepdim=True)))[..., 0]
    cls_idx = true_class_idx[..., 0].to(torch.int32)
    # one-hot select by ==, as the JAX package: a class index outside [0, nc)
    # picks nothing
    class_ids = torch.arange(logp.shape[-1], dtype=torch.int32, device=dev)
    picked = torch.sum(torch.where(class_ids == cls_idx[..., None], logp,
                                   torch.zeros_like(logp)), dim=-1)
    class_loss = torch.sum(obj_mask * (lse - picked))

    return torch.stack([xy_loss, wh_loss, obj_loss, class_loss])


def make_loss_fn(anchors_table, nclasses: int):
    """Returns loss(y_true_grids, y_pred_grids) → (nscales, 4) term matrix;
    ``anchors_table[i]`` pairs with head output i (13-grid first)."""

    def loss_fn(y_true_grids, y_pred_grids):
        return torch.stack([
            yolo_loss_terms(t, p, anchors_table[i], nclasses)
            for i, (t, p) in enumerate(zip(y_true_grids, y_pred_grids))])

    return loss_fn
