"""COCO-JSON → TFRecords converter (the dataset tooling the reference assumes).

Counterpart of the JAX package's ``tools/create_tfrecords.py``, with the same
command line and the same bytes: every shard and the ``.names`` file are
byte-identical to that tool's, the records written by the port's
``data/tfrecord.py`` (``encode_example``, ``write_tfrecord``).

The reference consumes TFRecords in the schema of its
``core/load_tfrecords.py:34-41`` (``image/encoded``,
``image/object/class/text``, ``image/object/bbox/{xmin,ymin,xmax,ymax}``
normalized) but ships no way to produce them. This converts a COCO-style
``{images, annotations, categories}`` JSON + images directory into sharded
``.tfrec`` files that both packages' loaders and the reference's read, plus an
optional ``.names`` class file in categories-list order (the dense-id order
both COCO loaders use).

Boxes are written normalized by each image's width/height; class labels are
written as category-name text (the id mapping happens at read time through
the ``.names`` file, as in the reference). A host tool: it touches no device.

Usage:
  python -m yolov3_tpu_torch.tools.create_tfrecords \\
      --images_dir datasets/pets_mini/train \\
      --annotations datasets/pets_mini/train/_annotations.coco.json \\
      --out_dir <dir> [--shard_size 1024] \\
      [--names_out <dir>/class.names] [--max_examples N]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

from ..data.tfrecord import encode_example, write_tfrecord


def coco_to_examples(images_dir: str, annotations_path: str,
                     max_examples: int | None = None):
    """Yield (serialized tf.train.Example, n_boxes) per image."""
    with open(annotations_path, "r") as f:
        coco = json.load(f)
    names = {c["id"]: c["name"] for c in coco["categories"]}
    by_image = defaultdict(list)
    for annot in coco["annotations"]:
        by_image[annot["image_id"]].append(annot)

    images = coco["images"]
    if max_examples:
        images = images[: int(max_examples)]
    for entry in images:
        with open(os.path.join(images_dir, entry["file_name"]), "rb") as f:
            encoded = f.read()
        iw, ih = float(entry["width"]), float(entry["height"])
        anns = by_image[entry["id"]]
        xmin, ymin, xmax, ymax, texts = [], [], [], [], []
        for annot in anns:
            x, y, w, h = annot["bbox"]
            xmin.append(x / iw)
            ymin.append(y / ih)
            xmax.append((x + w) / iw)
            ymax.append((y + h) / ih)
            texts.append(names[annot["category_id"]])
        yield encode_example({
            "image/encoded": [encoded],
            "image/object/class/text": texts,
            "image/object/bbox/xmin": xmin,
            "image/object/bbox/ymin": ymin,
            "image/object/bbox/xmax": xmax,
            "image/object/bbox/ymax": ymax,
        }), len(anns)


def load_names(annotations_path: str) -> list[str]:
    """Category names in categories-list order (the dense-id order)."""
    with open(annotations_path, "r") as f:
        return [c["name"] for c in json.load(f)["categories"]]


def main(argv=None) -> dict:
    """Convert; returns ``{"images", "boxes", "shards"}`` as printed."""
    parser = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.create_tfrecords",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--images_dir", required=True)
    parser.add_argument("--annotations", required=True, help="COCO JSON")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--shard_size", type=int, default=1024,
                        help="examples per .tfrec shard")
    parser.add_argument("--max_examples", type=int, default=None)
    parser.add_argument("--names_out", default=None,
                        help="also write a .names class file here")
    args = parser.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    shard, n_shards, n_images, n_boxes = [], 0, 0, 0

    def flush():
        nonlocal shard, n_shards
        if shard:
            write_tfrecord(os.path.join(args.out_dir, f"file_{n_shards:02d}.tfrec"), shard)
            n_shards += 1
            shard = []

    for record, boxes in coco_to_examples(args.images_dir, args.annotations,
                                          args.max_examples):
        shard.append(record)
        n_images += 1
        n_boxes += boxes
        if len(shard) >= args.shard_size:
            flush()
    flush()

    if args.names_out:
        with open(args.names_out, "w") as f:
            f.write("\n".join(load_names(args.annotations)) + "\n")

    print(f"wrote {n_images} images / {n_boxes} boxes in {n_shards} shard(s) "
          f"to {args.out_dir}")
    return {"images": n_images, "boxes": n_boxes, "shards": n_shards}


if __name__ == "__main__":
    main()
