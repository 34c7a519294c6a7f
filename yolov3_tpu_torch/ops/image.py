"""Device-side image ops (torch twins of data/image.py's host versions).

Counterpart of ``yolov3_tpu/ops/image.py``. ``resize_bilinear`` —
``F.interpolate(mode="bilinear", align_corners=False, antialias=False)``:
half-pixel centres, edges clamped, no antialiasing, the semantics of
tf.image.resize's default bilinear and of ``jax.image.resize`` with
``antialias=False``. ``letterbox_resize`` — aspect-preserving resize +
centre zero-pad, the scaled dims from ``data/image.py::letterbox_scaled_dims``
(tf.image.resize's rounding), so the host and device paths place the
content alike. ``resize_antialiased`` — ``jax.image.resize(…, "bilinear")``
with its default ``antialias=True``: a downscale widens the triangle kernel
by the scale factor (the trainer's multi-scale downscale on the device).

Images are channels-last, (…, H, W, C) float, on any device: use these to
resize on the card what was decoded on the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..data.image import letterbox_scaled_dims


def resize_bilinear(img, out_h: int, out_w: int):
    """(…, H, W, C) → (…, out_h, out_w, C); TF default bilinear semantics."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def resize_antialiased(img, out_h: int, out_w: int):
    """(…, H, W, C) → (…, out_h, out_w, C); bilinear with antialiasing."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def letterbox_resize(img, target_height: int, target_width: int):
    """Aspect-preserving resize + centre zero-pad (core/utils.py:17-28
    semantics). img: (H, W, C) or (B, H, W, C)."""
    h, w = img.shape[-3], img.shape[-2]
    nh, nw = letterbox_scaled_dims(h, w, target_height, target_width)
    resized = resize_bilinear(img, nh, nw)
    top = (target_height - nh) // 2
    left = (target_width - nw) // 2
    # F.pad pads the last dims first: (C), (W), (H)
    return F.pad(resized, (0, 0, left, target_width - nw - left,
                           top, target_height - nh - top))
