"""COCO-format evaluation export — pycocotools interop.

New capability (the reference only dumps per-class `.npy` counter
histograms — reference evaluate_yolov3.py:227-236): the evaluate app can
write the standard COCO interchange pair

  ``detections.json``    — the results list pycocotools' ``loadRes``
                           takes: ``[{image_id, category_id, bbox
                           [x,y,w,h] px, score}, …]``
  ``ground_truth.json``  — a minimal COCO dataset dict (images,
                           annotations with area/iscrowd, categories)

so any external tooling (pycocotools COCOeval, fiftyone, TIDE, …) can
re-score or visualize the run. Category ids follow the COCO convention of
starting at 1 (dense class index + 1); coordinates are pixels in the
network-input frame (the square ``image_size`` the tfrecords eval pipeline
resizes to — the same frame the in-process evaluator scores in).

Framework-neutral copy of ``yolov3_tpu/eval/coco_export.py`` (the port imports nothing of the
JAX package). tests/test_torch_eval.py pins it to its original.
"""

from __future__ import annotations

import json
import os


class CocoExporter:
    """Accumulates per-image detections + ground truth, writes the pair."""

    def __init__(self, class_names, image_size: int):
        self.class_names = list(class_names)
        self.image_size = int(image_size)
        self.images = []
        self.annotations = []
        self.detections = []

    def _to_xywh(self, box):
        x1, y1, x2, y2 = (float(v) * self.image_size for v in box)
        return [x1, y1, x2 - x1, y2 - y1]

    def add_image(self, det_boxes, det_classes, det_scores,
                  gt_boxes, gt_classes) -> int:
        """One image's valid detections + valid gt (normalized xyxy).
        Returns the assigned 1-based image id."""
        image_id = len(self.images) + 1
        self.images.append({"id": image_id, "width": self.image_size,
                            "height": self.image_size})
        for box, cls, score in zip(det_boxes, det_classes, det_scores):
            self.detections.append({
                "image_id": image_id,
                "category_id": int(cls) + 1,
                "bbox": [round(v, 3) for v in self._to_xywh(box)],
                "score": round(float(score), 5),
            })
        for box, cls in zip(gt_boxes, gt_classes):
            xywh = self._to_xywh(box)
            self.annotations.append({
                "id": len(self.annotations) + 1,
                "image_id": image_id,
                "category_id": int(cls) + 1,
                "bbox": [round(v, 3) for v in xywh],
                "area": round(xywh[2] * xywh[3], 3),
                "iscrowd": 0,
            })
        return image_id

    def write(self, out_dir: str):
        """Write ``detections.json`` + ``ground_truth.json``; returns paths."""
        os.makedirs(out_dir, exist_ok=True)
        det_path = os.path.join(out_dir, "detections.json")
        gt_path = os.path.join(out_dir, "ground_truth.json")
        with open(det_path, "w") as f:
            json.dump(self.detections, f)
        gt = {
            "images": self.images,
            "annotations": self.annotations,
            "categories": [{"id": i + 1, "name": name}
                           for i, name in enumerate(self.class_names)],
        }
        with open(gt_path, "w") as f:
            json.dump(gt, f)
        return det_path, gt_path


__all__ = ["CocoExporter"]
