"""COCO-JSON dataset builder (reference core/create_dataset_from_files.py).

Parses {images, annotations, categories} eagerly, remaps sparse category
ids to dense indices in categories-list order (:63), converts [x,y,w,h] →
[xmin,ymin,xmax,ymax] normalized by image dims (:37-47), pads label rows
to max_bboxes (:51). Images are decoded and resized lazily per-iteration
(plain square resize, /255 — :21-27; note the reference divides *before*
resizing there, an order that is numerically identical for bilinear).

Framework-neutral copy of ``yolov3_tpu/data/coco_json.py`` (host code in numpy; the port
imports nothing of the JAX package). tests/test_torch_data.py pins it to its original.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from .image import decode_image, resize_bilinear
from .pipeline import Dataset


def _labels_for_image(image_entry, anns, cat_map, max_bboxes):
    if len(anns) > max_bboxes:
        # fail loudly like the tfrecord path (tfrecord.py) — silently
        # dropping gt boxes would inflate recall/mAP with no trace
        raise ValueError(
            f"image {image_entry.get('file_name', image_entry.get('id'))} has "
            f"{len(anns)} annotations > max_bboxes={max_bboxes}; raise max_bboxes")
    labels = np.zeros((max_bboxes, 6), np.float32)
    n = len(anns)
    if n:
        iw, ih = float(image_entry["width"]), float(image_entry["height"])
        for row, annot in enumerate(anns[:n]):
            x, y, w, h = annot["bbox"]
            labels[row] = [x / iw, y / ih, (x + w) / iw, (y + h) / ih, 1.0,
                           float(cat_map[annot["category_id"]])]
    return labels


def create_dataset_from_files(images_dir, annotations_path, image_size,
                              max_dataset_examples=None, max_bboxes=100):
    """Returns (Dataset of (image, labels), size)."""
    with open(annotations_path, "r") as f:
        annotations = json.load(f)

    cat_map = {c["id"]: i for i, c in enumerate(annotations["categories"])}
    num = len(annotations["images"])
    if max_dataset_examples:
        num = min(num, int(max_dataset_examples))
    images_list = annotations["images"][:num]

    by_image = defaultdict(list)
    for annot in annotations["annotations"]:
        by_image[annot["image_id"]].append(annot)

    entries = []
    for image_entry in images_list:
        path = f"{images_dir}/{image_entry['file_name']}"
        labels = _labels_for_image(image_entry, by_image[image_entry["id"]], cat_map, max_bboxes)
        entries.append((path, labels))

    def gen():
        for path, labels in entries:
            with open(path, "rb") as f:
                img = decode_image(f.read()).astype(np.float32)
            img = resize_bilinear(img / 255.0, image_size, image_size)
            yield img, labels

    return Dataset(gen, size=len(entries)), len(entries)
