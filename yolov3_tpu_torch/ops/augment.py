"""Training augmentation on the device, batched — drawing split from applying.

Counterpart of ``yolov3_tpu/ops/augment.py`` (the reference has no
augmentation): random horizontal flip (boxes mirrored); scale-and-shift
("zoom out": the image shrunk by s ∈ [1 − scale_jitter, 1] and placed at a
random offset on a gray canvas, boxes moved alike); Darknet-style HSV jitter;
brightness / contrast; mosaic (each output image a 4-image composite of its
batch neighbours warped into the quadrants around a random centre, the first
``max_boxes`` valid boxes of the four kept). Mosaic runs first, on the
un-augmented batch; then flip, scale-shift, HSV and colour per image.

The JAX package draws with threefry keys, which a ``torch.Generator`` cannot
reproduce, so the two halves are apart here:

  * ``draw_augment`` draws every random value of a batch from a CPU
    ``torch.Generator`` (``step_generator(seed, step)`` seeds one per train
    step, as the JAX package folds the step into ``PRNGKey(seed)``), so a
    seed gives the same draws on every device;
  * ``apply_augment`` applies given draws to an NHWC f32 batch on its
    device, in the JAX package's float32 operations and order: the gathers'
    source coordinates are ``(arange(n) / n − offset) / span``, then ``· n``,
    clipped and truncated (``source_indices``), so the same draws gather the
    same pixels as ``augment_batch`` does.

``draws`` is a dict of (B, …) tensors holding only the enabled transforms'
values: ``mosaic_center`` (B, 2) and ``mosaic_take`` (B,) bool; ``flip`` (B,)
bool; ``scale`` (B,) and ``offset`` (B, 2) = (ox, oy); ``hue`` (B,) shifts;
``saturation`` / ``exposure`` (B,) multiplicative factors (exp of the
log-uniform draw); ``brightness`` (B,) and ``contrast`` (B,).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _check_bounds(saturation, exposure):
    for name, bound in (("saturation", saturation), ("exposure", exposure)):
        if 0 < bound <= 1:
            raise ValueError(
                f"{name} is a scale BOUND > 1 ({name}: 1.5 means "
                f"scales in [1/1.5, 1.5]); got {bound} — use 0 to disable")


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one train step's draws, keyed by (seed, step)."""
    return torch.Generator().manual_seed(int(seed) * 2 ** 32 + int(step))


def draw_augment(batch: int, generator: torch.Generator, flip: bool = True,
                 scale_jitter: float = 0.25, brightness: float = 0.1, contrast: float = 0.1,
                 mosaic: float = 0.0, hue: float = 0.0, saturation: float = 0.0,
                 exposure: float = 0.0):
    """Every random value of one batch's augmentation → ``draws`` (CPU
    tensors). The options are ``augment_batch``'s: ``mosaic`` the probability
    per image; ``hue`` a shift bound (fraction of the wheel); ``saturation`` /
    ``exposure`` log-uniform scale bounds > 1 (0 disables; (0, 1] raises)."""
    _check_bounds(saturation, exposure)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (batch,), generator=generator,
                                           dtype=torch.float32)

    draws = {}
    if mosaic > 0:
        draws["mosaic_center"] = uniform(0.3, 0.7, batch, 2)
        draws["mosaic_take"] = uniform(0.0, 1.0) < mosaic
    if flip:
        draws["flip"] = uniform(0.0, 1.0) < 0.5
    if scale_jitter > 0:
        s = uniform(1.0 - scale_jitter, 1.0)
        draws["scale"] = s
        draws["offset"] = uniform(0.0, 1.0, batch, 2) * (1.0 - s)[:, None]
    if hue > 0:
        draws["hue"] = uniform(-hue, hue)
    for name, bound in (("saturation", saturation), ("exposure", exposure)):
        if bound > 1:
            log_bound = math.log(float(np.float32(bound)))
            draws[name] = torch.exp(uniform(-log_bound, log_bound))
    if brightness > 0 or contrast > 0:
        draws["brightness"] = uniform(-brightness, brightness)
        draws["contrast"] = uniform(1.0 - contrast, 1.0 + contrast)
    return draws


def source_indices(n: int, lo, span):
    """Canvas position → source index of a reverse-warp gather along one axis
    of length ``n``, per image: ``t = (arange(n) / n − lo) / span`` (lo, span:
    (B,) f32), index ``trunc(clip(t · n, 0, n − 1))``, valid where
    0 ≤ t < 1. Returns ((B, n) int64 indices, (B, n) bool valid)."""
    t = ((torch.arange(n, dtype=torch.float32, device=lo.device) / n)[None, :]
         - lo[:, None]) / span[:, None]
    index = torch.clamp(t * n, 0, n - 1).to(torch.int64)
    return index, (t >= 0) & (t < 1.0)


def _warp(images, lo_x, span_x, lo_y, span_y, fill):
    """Reverse-warp gather of every image: output pixel (i, j) of image b is
    ``images[b, yi[b, i], xi[b, j]]`` where both are valid, ``fill`` elsewhere."""
    b, h, w, _ = images.shape
    yi, vy = source_indices(h, lo_y, span_y)
    xi, vx = source_indices(w, lo_x, span_x)
    rows = torch.arange(b, device=images.device)[:, None, None]
    gathered = images[rows, yi[:, :, None], xi[:, None, :]]
    mask = (vy[:, :, None] & vx[:, None, :])[..., None]
    return torch.where(mask, gathered, torch.tensor(fill, dtype=images.dtype,
                                                    device=images.device))


def _flip(images, labels, do_flip):
    images = torch.where(do_flip[:, None, None, None], images.flip(2), images)
    mirror = do_flip[:, None] & (labels[..., 4] > 0)
    xmin, xmax = labels[..., 0], labels[..., 2]
    labels = torch.cat([torch.where(mirror, 1.0 - xmax, xmin)[..., None], labels[..., 1:2],
                        torch.where(mirror, 1.0 - xmin, xmax)[..., None], labels[..., 3:]],
                       dim=-1)
    return images, labels


def _scale_shift(images, labels, scale, offset, fill=0.5):
    """Shrink each image by ``scale`` and place it at normalized ``offset``
    on a same-size gray canvas; boxes move alike, clipped, padded rows zero."""
    ox, oy = offset[:, 0], offset[:, 1]
    images = _warp(images, ox, scale, oy, scale, fill)
    obj = labels[..., 4:5]
    boxes = (labels[..., :4] * scale[:, None, None]
             + torch.stack([ox, oy, ox, oy], dim=-1)[:, None, :])
    boxes = torch.clamp(boxes, 0.0, 1.0) * obj
    return images, torch.cat([boxes, labels[..., 4:]], dim=-1)


def _mosaic(images, labels, centers, take):
    """Images b..b+3 (wrapping) warped into the quadrants around centre b;
    quadrant supports are disjoint, so the canvas is their sum. The boxes of
    the four concatenate and a stable sort on validity keeps the first M
    valid ones in source order. ``take`` picks mosaic or original per image."""
    max_boxes = labels.shape[1]
    cx, cy = centers[:, 0], centers[:, 1]
    zero, one = torch.zeros_like(cx), torch.ones_like(cx)
    rects = ((zero, cx, zero, cy), (cx, one, zero, cy), (zero, cx, cy, one), (cx, one, cy, one))
    canvas = torch.zeros_like(images)
    parts = []
    for q, (x0, x1, y0, y1) in enumerate(rects):
        canvas = canvas + _warp(torch.roll(images, -q, 0), x0, x1 - x0, y0, y1 - y0, 0.0)
        lab = torch.roll(labels, -q, 0)
        scale = torch.stack([x1 - x0, y1 - y0, x1 - x0, y1 - y0], dim=-1)[:, None, :]
        offset = torch.stack([x0, y0, x0, y0], dim=-1)[:, None, :]
        boxes = (lab[..., :4] * scale + offset) * lab[..., 4:5]
        parts.append(torch.cat([boxes, lab[..., 4:]], dim=-1))
    cat = torch.cat(parts, dim=1)  # (B, 4M, 6)
    order = torch.argsort(-cat[..., 4], dim=1, stable=True)
    kept = torch.take_along_dim(cat, order[..., None], dim=1)[:, :max_boxes]
    return (torch.where(take[:, None, None, None], canvas, images),
            torch.where(take[:, None, None], kept, labels))


def rgb_to_hsv(img):
    """(…, 3) RGB in [0, 1] → HSV, colorsys-equivalent."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(dim=-1)
    minc = img.amin(dim=-1)
    c = maxc - minc
    safe = torch.where(c > 0, c, 1.0)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(c > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    s = torch.where(maxc > 0, c / torch.where(maxc > 0, maxc, 1.0), 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(img):
    """(…, 3) HSV → RGB, colorsys-equivalent, with a select chain over the
    sextant as the JAX package's."""
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*choices):
        out = choices[0]
        for k, c in enumerate(choices[1:], start=1):
            out = torch.where(i == k, c, out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def _jitter_hsv(images, hue, saturation, exposure):
    """Hue shifted by ``hue`` (wrapping), saturation and value scaled by the
    given factors and clipped to [0, 1]; a None is a disabled channel."""
    hsv = rgb_to_hsv(images)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    per_image = (slice(None), None, None)
    if hue is not None:
        h = torch.remainder(h + hue[per_image], 1.0)
    if saturation is not None:
        s = torch.clamp(s * saturation[per_image], 0.0, 1.0)
    if exposure is not None:
        v = torch.clamp(v * exposure[per_image], 0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def _jitter_colors(images, brightness, contrast):
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    c = contrast[:, None, None, None]
    return torch.clamp((images - mean) * c + mean + brightness[:, None, None, None], 0.0, 1.0)


def apply_augment(images, labels, draws):
    """Apply ``draws`` (see the module docstring; on any device, moved to the
    images') to images (B, H, W, 3) f32 in [0, 1] and labels (B, M, 6) →
    (images, labels) of the same shapes."""
    d = {k: v.to(images.device) for k, v in draws.items()}
    if "mosaic_take" in d:
        images, labels = _mosaic(images, labels, d["mosaic_center"], d["mosaic_take"])
    if "flip" in d:
        images, labels = _flip(images, labels, d["flip"])
    if "scale" in d:
        images, labels = _scale_shift(images, labels, d["scale"], d["offset"])
    if any(k in d for k in ("hue", "saturation", "exposure")):
        images = _jitter_hsv(images, d.get("hue"), d.get("saturation"), d.get("exposure"))
    if "brightness" in d:
        images = _jitter_colors(images, d["brightness"], d["contrast"])
    return images, labels


def augment_batch(images, labels, generator: torch.Generator, **options):
    """Draw from ``generator`` and apply: the port's ``augment_batch``.
    ``options`` are ``draw_augment``'s keyword arguments."""
    return apply_augment(images, labels, draw_augment(images.shape[0], generator, **options))
