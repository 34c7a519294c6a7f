"""Pascal VOC dataset reader — extension (the reference reads TFRecords
and COCO-JSON only; SURVEY §2 rows 3-4).

Reads the standard VOC layout — one XML per image with ``<object>``
entries (``<name>``, ``<bndbox>`` with 1-based inclusive pixel corners) —
and yields the same ``(image, (max_bboxes, 6))`` stream every other
source produces: square-resized float image + normalized
``[xmin, ymin, xmax, ymax, obj, class_id]`` rows, class ids resolved
through the run's ``.names`` file (same name→dense-id convention as the
TFRecord loader). Selected via ``input_data_source: voc`` with
``voc: {train: {images_dir, annotations_dir}, valid: {…}}``.

Framework-neutral copy of ``yolov3_tpu/data/voc.py`` (host code in numpy; the port
imports nothing of the JAX package). tests/test_torch_data.py pins it to its original.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from .image import decode_image, resize_bilinear
from .pipeline import Dataset


def _parse_voc_xml(path, class_to_id, max_bboxes):
    """One annotation file → (image file name, (max_bboxes, 6) labels)."""
    root = ET.parse(path).getroot()
    filename = root.findtext("filename")
    if not filename:
        raise ValueError(f"{path}: missing <filename>")
    size = root.find("size")
    if size is None:
        raise ValueError(f"{path}: missing <size>")
    try:
        w = float(size.findtext("width"))
        h = float(size.findtext("height"))
    except (TypeError, ValueError) as exc:
        raise ValueError(f"{path}: malformed <size> width/height: {exc}") from exc
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: bad image size {w}x{h}")

    objects = list(root.iter("object"))
    if len(objects) > max_bboxes:
        # same loud failure as the tfrecord / COCO-JSON loaders — silently
        # dropping gt boxes would inflate recall/mAP with no trace
        raise ValueError(
            f"{path}: {len(objects)} objects exceed max_bboxes={max_bboxes}; "
            f"raise max_bboxes in the run config")
    labels = np.zeros((max_bboxes, 6), np.float32)
    for n, obj in enumerate(objects):
        name = (obj.findtext("name") or "").strip()
        if name not in class_to_id:
            raise ValueError(
                f"{path}: class {name!r} not in the classes file "
                f"(known: {sorted(class_to_id)[:10]}…)")
        box = obj.find("bndbox")
        if box is None:
            raise ValueError(f"{path}: <object> {name!r} missing <bndbox>")
        try:
            # VOC pixel coordinates are 1-based inclusive
            xmin = (float(box.findtext("xmin")) - 1.0) / w
            ymin = (float(box.findtext("ymin")) - 1.0) / h
            xmax = (float(box.findtext("xmax")) - 1.0) / w
            ymax = (float(box.findtext("ymax")) - 1.0) / h
        except (TypeError, ValueError) as exc:
            raise ValueError(f"{path}: malformed <bndbox> for {name!r}: "
                             f"{exc}") from exc
        labels[n] = [max(xmin, 0.0), max(ymin, 0.0),
                     min(xmax, 1.0), min(ymax, 1.0), 1.0, class_to_id[name]]
    return filename, labels


def create_voc_dataset(images_dir, annotations_dir, image_size,
                       classes_name_file, max_dataset_examples=None,
                       max_bboxes=100):
    """Returns (Dataset of (image, labels), size) — same contract as
    ``coco_json.create_dataset_from_files``."""
    from ..config import read_class_names

    class_to_id = {name: i
                   for i, name in enumerate(read_class_names(classes_name_file))}
    xml_files = sorted(
        os.path.join(annotations_dir, f)
        for f in os.listdir(annotations_dir) if f.endswith(".xml"))
    if max_dataset_examples:
        xml_files = xml_files[: int(max_dataset_examples)]
    if not xml_files:
        raise ValueError(f"no .xml annotations in {annotations_dir}")

    entries = []
    for xml_path in xml_files:
        filename, labels = _parse_voc_xml(xml_path, class_to_id, max_bboxes)
        entries.append((os.path.join(images_dir, filename), labels))

    def gen():
        for path, labels in entries:
            with open(path, "rb") as f:
                img = decode_image(f.read()).astype(np.float32)
            img = resize_bilinear(img / 255.0, image_size, image_size)
            yield img, labels

    return Dataset(gen, size=len(entries)), len(entries)
