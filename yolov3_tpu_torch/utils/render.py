"""Detection rendering — pure PIL/numpy (no TF).

Output parity with reference core/render_utils.py: 1-px box edges drawn in
``bbox_color`` (the draw_bounding_boxes analog, :21-36), then per-box text
labels '"class: NN%"' on a colored background, color = hash(class_name)
into the PIL colormap (:71-91). Returns a PIL image + the detections list
whose repr is written to detect.txt (inference.py:39-41).

Framework-neutral copy of ``yolov3_tpu/utils/render.py`` (the port imports nothing of the
JAX package). tests/test_torch_eval.py pins it to its original.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageColor, ImageDraw, ImageFont

_FONT_PATHS = [
    "/usr/share/fonts/truetype/liberation/LiberationSansNarrow-Regular.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
]


def _load_font(font_size: int):
    for path in _FONT_PATHS:
        try:
            return ImageFont.truetype(path, font_size)
        except IOError:
            continue
    return ImageFont.load_default()


def _text_size(font, text: str):
    # PIL ≥10 removed font.getsize
    if hasattr(font, "getbbox"):
        l, t, r, b = font.getbbox(text)
        return r - l, b - t
    return font.getsize(text)


def render_bboxes(image: np.ndarray, bboxes, color=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Draw 1-px box edges on a float image in [0,1]. bboxes: (N,4) xyxy norm."""
    img = np.array(image, np.float32, copy=True)
    h, w = img.shape[:2]
    color = np.asarray(color, np.float32)
    for box in np.asarray(bboxes, np.float32):
        xmin, ymin, xmax, ymax = box
        x0 = int(np.clip(round(xmin * (w - 1)), 0, w - 1))
        x1 = int(np.clip(round(xmax * (w - 1)), 0, w - 1))
        y0 = int(np.clip(round(ymin * (h - 1)), 0, h - 1))
        y1 = int(np.clip(round(ymax * (h - 1)), 0, h - 1))
        if x1 <= x0 or y1 <= y0:
            continue
        img[y0, x0 : x1 + 1] = color
        img[y1, x0 : x1 + 1] = color
        img[y0 : y1 + 1, x0] = color
        img[y0 : y1 + 1, x1] = color
    return img


def _annotate_text(image_pil: Image.Image, bbox, class_name: str, score: float, font_size: int):
    im_width, im_height = image_pil.size
    xmin, ymin, xmax, ymax = (
        bbox[0] * im_width, bbox[1] * im_height, bbox[2] * im_width, bbox[3] * im_height
    )
    colors = list(ImageColor.colormap.values())
    color = colors[hash(class_name) % len(colors)]
    detections_str = "{}: {}%".format(class_name, int(100 * score))

    ymin_text = ymin if ymin > 0 else font_size
    xmin_text = xmin if xmin > 0 else 0

    draw = ImageDraw.Draw(image_pil)
    font = _load_font(font_size)
    text_width, text_height = _text_size(font, detections_str)
    margin = np.ceil(0.05 * text_height)
    total = (1 + 2 * 0.05) * text_height
    text_bottom = ymin_text if ymin_text > total else ymin_text + total
    draw.rectangle(
        [(xmin_text, text_bottom - text_height - 2 * margin), (xmin_text + text_width, text_bottom)],
        fill=color,
    )
    draw.text(
        (xmin_text + margin, text_bottom - text_height - margin),
        detections_str, fill="black", font=font,
    )
    return (detections_str, float(xmin), float(ymin), float(xmax), float(ymax))


def annotate_detections(image, class_names, bboxes, scores, bbox_color, font_size):
    """image: float array in [0,1] → (PIL image, detections list)."""
    annotated = Image.fromarray(np.uint8(np.clip(image, 0, 1) * 255)).convert("RGB")
    detections = []
    for bbox, class_name, score in zip(np.asarray(bboxes), class_names, np.asarray(scores)):
        detections.append(_annotate_text(annotated, bbox, class_name, float(score), font_size))
    return annotated, detections


def render_text_annotated_bboxes(image, bboxes, classes_names, scores, bbox_color, font_size):
    rendered = render_bboxes(np.asarray(image), bboxes, bbox_color)
    return annotate_detections(rendered, classes_names, bboxes, scores, bbox_color, font_size)
