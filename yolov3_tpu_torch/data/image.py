"""Host-side image ops: decode (PIL) + TF-semantics resize in numpy.

``resize_bilinear`` reproduces tf.image.resize's default path (bilinear,
half_pixel_centers=True, antialias=False) so box/score outputs stay
comparable with the reference pipeline (load_tfrecords.py:44-46,
create_dataset_from_files.py:21-27). ``letterbox_resize`` reproduces
core/utils.py:17-28 (aspect-preserving resize + center pad-to-square).

Framework-neutral copy of ``yolov3_tpu/data/image.py``: preprocessing
stays on the host in numpy, as in the JAX package's serving path.
"""

from __future__ import annotations

import io

import numpy as np


def decode_image(encoded: bytes) -> np.ndarray:
    """JPEG/PNG bytes → uint8 (H, W, 3)."""
    from PIL import Image

    img = Image.open(io.BytesIO(encoded))
    img = img.convert("RGB")
    return np.asarray(img, np.uint8)


def _resample_axis(src_len: int, dst_len: int):
    """Half-pixel bilinear gather indices/weights for one axis."""
    if dst_len == src_len:
        idx = np.arange(src_len)
        return idx, idx, np.zeros(src_len, np.float32)
    # float32 throughout: TF's CPU kernel computes the half-pixel source
    # coordinates in float, so float64 here diverges by up to ~4e-5 on
    # 400+-pixel axes (last-ulp coordinate differences flip lerp weights)
    scale = np.float32(src_len) / np.float32(dst_len)
    coords = (np.arange(dst_len, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    lo = np.floor(coords)
    frac = (coords - lo).astype(np.float32)
    lo = np.clip(lo, 0, src_len - 1).astype(np.int64)
    hi = np.clip(lo + 1, 0, src_len - 1)
    # clip fractional weight where coords < 0 (TF clamps the same way)
    frac = np.where(coords < 0, np.float32(0.0), frac)
    return lo, hi, frac


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) float → (out_h, out_w, C) float; TF bilinear semantics."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    ylo, yhi, yf = _resample_axis(h, out_h)
    xlo, xhi, xf = _resample_axis(w, out_w)

    top = img[ylo]  # (out_h, W, C)
    bot = img[yhi]
    rows = top + (bot - top) * yf[:, None, None]
    left = rows[:, xlo]
    right = rows[:, xhi]
    return left + (right - left) * xf[None, :, None]


def letterbox_scaled_dims(h: int, w: int, target_height: int, target_width: int) -> tuple[int, int]:
    """Scaled (nh, nw) exactly as tf.image.resize(preserve_aspect_ratio=True):
    float32 scale ratios, float32 multiply, round-half-to-even. Clamped to ≥1
    so a degenerate aspect ratio can't produce an empty image (TF would emit
    a 0-row tensor there; the pad step then yields all zeros either way)."""
    scale = np.minimum(
        np.float32(target_height) / np.float32(h),
        np.float32(target_width) / np.float32(w),
    )
    nh = int(np.round(scale * np.float32(h)))
    nw = int(np.round(scale * np.float32(w)))
    return max(nh, 1), max(nw, 1)


def letterbox_unmap_boxes(boxes: np.ndarray, orig_h: int, orig_w: int,
                          target_height: int, target_width: int) -> np.ndarray:
    """Map normalized xyxy boxes from the letterboxed (target) frame back
    to the ORIGINAL image's normalized frame — the inverse of where
    ``letterbox_resize`` placed the content (same scaled-dims/offset math),
    clipped to [0, 1]."""
    nh, nw = letterbox_scaled_dims(orig_h, orig_w, target_height, target_width)
    top = (target_height - nh) // 2
    left = (target_width - nw) // 2
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    out = np.empty_like(boxes)
    out[:, 0::2] = (boxes[:, 0::2] * target_width - left) / nw
    out[:, 1::2] = (boxes[:, 1::2] * target_height - top) / nh
    return np.clip(out, 0.0, 1.0)


def letterbox_resize(img: np.ndarray, target_height: int, target_width: int) -> np.ndarray:
    """Aspect-preserving resize + center zero-pad (core/utils.py:17-28).

    tf.image.resize(preserve_aspect_ratio=True) computes
    scale = min(th/h, tw/w) in float32 and ROUNDS (half-to-even) the scaled
    dims — `round(scale * dim)`, not floor (TF image_ops_impl
    `_resize_images_common`). Mirrored exactly here so padding offsets and
    box positions match the reference pipeline for non-square inputs.
    """
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    nh, nw = letterbox_scaled_dims(h, w, target_height, target_width)
    resized = resize_bilinear(img, nh, nw)
    out = np.zeros((target_height, target_width, img.shape[2]), np.float32)
    top = (target_height - nh) // 2
    left = (target_width - nw) // 2
    out[top : top + nh, left : left + nw] = resized
    return out
