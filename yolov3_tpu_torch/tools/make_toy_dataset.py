"""Generate a standalone toy shapes detection dataset (fixtures).

The port's copy of the JAX package's ``tools/make_toy_dataset.py``: the
same seeded draws and the same bytes (PIL's JPEG encoder at quality 95), with
the records written by the port's ``data/tfrecord.py``. Produces, under
``datasets/shapes_toy/`` (or the given root):
  * class.names (3 shape classes)
  * anchors/anchors.txt (9) + anchors_tiny.txt (6)
  * tfrecords/{train,val,test}/file_00.tfrec — JPEG images + boxes in the
    reference feature schema;
  * coco/{images/*.jpg, annotations.json} — the data_files/COCO-JSON mode.

Deterministic (seeded): each split draws from its own stream,
``RandomState([seed, split_index])``, so a corpus's val split does not depend
on its train size. The bundled ``datasets/shapes_toy`` files are older: one
stream, ``RandomState(seed)``, through train, val and test; ``draw_example``
and ``jpeg_bytes`` driven that way reproduce them byte for byte. The
convergence recipe (``tools/train_convergence.py``) draws with
``max_overlap`` 0.15.

Usage:
  python -m yolov3_tpu_torch.tools.make_toy_dataset [root] [--n_train 32]
      [--n_val 16] [--n_test 8] [--seed 7] [--img_size 256] [--max_overlap 0.15]
"""

from __future__ import annotations

import io
import json
import os

import numpy as np

from ..data.tfrecord import encode_example, write_tfrecord

CLASSES = ["circle", "square", "triangle"]
IMG_SIZE = 256


def _iou(a, b):
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / ua if ua > 0 else 0.0


def draw_example(rng, img_size=IMG_SIZE, max_overlap=None):
    """One synthetic example. ``max_overlap=None`` reproduces the bundled
    fixtures bit-exactly (unconstrained placement — later shapes may fully
    occlude earlier ones, which caps achievable detection quality);
    a float caps the pairwise box IoU by rejection-sampling placements
    (shapes that can't be placed within 50 tries are skipped)."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (img_size, img_size), (20, 24, 28))
    draw = ImageDraw.Draw(img)
    n = rng.randint(1, 4)
    boxes, classes = [], []
    for _ in range(n):
        cls = rng.randint(len(CLASSES))
        # same size *fraction* range at every resolution (40..100 @256)
        size = rng.randint(round(img_size * 40 / 256), round(img_size * 100 / 256))
        x0 = rng.randint(0, img_size - size)
        y0 = rng.randint(0, img_size - size)
        if max_overlap is not None:
            placed = False
            for _try in range(50):
                cand = [x0, y0, x0 + size, y0 + size]
                if all(_iou(cand, [b[0] * img_size, b[1] * img_size,
                                   b[2] * img_size, b[3] * img_size])
                       <= max_overlap for b in boxes):
                    placed = True
                    break
                x0 = rng.randint(0, img_size - size)
                y0 = rng.randint(0, img_size - size)
            if not placed:
                continue
        x1, y1 = x0 + size, y0 + size
        color = tuple(int(c) for c in rng.randint(90, 255, 3))
        if cls == 0:
            draw.ellipse([x0, y0, x1, y1], fill=color)
        elif cls == 1:
            draw.rectangle([x0, y0, x1, y1], fill=color)
        else:
            draw.polygon([(x0, y1), (x1, y1), ((x0 + x1) // 2, y0)], fill=color)
        boxes.append([x0 / img_size, y0 / img_size, x1 / img_size, y1 / img_size])
        classes.append(cls)
    return img, boxes, classes


def jpeg_bytes(img):
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def main(root="datasets/shapes_toy", n_train=32, n_val=16, n_test=8, seed=7,
         img_size=IMG_SIZE, max_overlap=None):
    os.makedirs(f"{root}/anchors", exist_ok=True)
    with open(f"{root}/class.names", "w") as f:
        f.write("\n".join(CLASSES) + "\n")

    anchors9 = np.array(
        [[0.17, 0.17], [0.20, 0.20], [0.24, 0.24],
         [0.28, 0.28], [0.31, 0.31], [0.34, 0.34],
         [0.36, 0.36], [0.38, 0.38], [0.40, 0.40]], np.float32)
    np.savetxt(f"{root}/anchors/anchors.txt", anchors9, delimiter=",")
    np.savetxt(f"{root}/anchors/anchors_tiny.txt", anchors9[:6], delimiter=",")

    coco = {"images": [], "annotations": [], "categories":
            [{"id": 10 + i, "name": n} for i, n in enumerate(CLASSES)]}
    ann_id = 0
    os.makedirs(f"{root}/coco/images", exist_ok=True)

    for si, (split, count) in enumerate(
            (("train", n_train), ("val", n_val), ("test", n_test))):
        # independent RNG stream per split: with a single sequential stream,
        # the val images of an (n_train=N) corpus are the train images
        # 2048..N of any larger corpus generated with the same seed — which
        # silently leaks val into train across corpus sizes (caught when a
        # leaked eval scored 0.99 vs 0.79 honest)
        rng = np.random.RandomState([seed, si])
        os.makedirs(f"{root}/tfrecords/{split}", exist_ok=True)
        records = []
        for i in range(count):
            img, boxes, classes = draw_example(rng, img_size, max_overlap)
            encoded = jpeg_bytes(img)
            boxes_arr = np.asarray(boxes, np.float32)
            records.append(encode_example({
                "image/encoded": [encoded],
                "image/object/class/text": [CLASSES[c] for c in classes],
                "image/object/bbox/xmin": boxes_arr[:, 0].tolist(),
                "image/object/bbox/ymin": boxes_arr[:, 1].tolist(),
                "image/object/bbox/xmax": boxes_arr[:, 2].tolist(),
                "image/object/bbox/ymax": boxes_arr[:, 3].tolist(),
            }))
            if split == "train":
                fname = f"img_{i:03d}.jpg"
                with open(f"{root}/coco/images/{fname}", "wb") as f:
                    f.write(encoded)
                img_id = i
                coco["images"].append({"id": img_id, "file_name": fname,
                                       "width": img_size, "height": img_size})
                for box, c in zip(boxes, classes):
                    x0, y0, x1, y1 = (np.asarray(box) * img_size).tolist()
                    coco["annotations"].append({
                        "id": ann_id, "image_id": img_id, "category_id": 10 + c,
                        "bbox": [x0, y0, x1 - x0, y1 - y0],
                        "area": (x1 - x0) * (y1 - y0), "iscrowd": 0,
                    })
                    ann_id += 1
        write_tfrecord(f"{root}/tfrecords/{split}/file_00.tfrec", records)

    with open(f"{root}/coco/annotations.json", "w") as f:
        json.dump(coco, f)
    print(f"toy dataset written under {root}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.make_toy_dataset",
                                 description=__doc__)
    ap.add_argument("root", nargs="?", default="datasets/shapes_toy")
    ap.add_argument("--n_train", type=int, default=32)
    ap.add_argument("--n_val", type=int, default=16)
    ap.add_argument("--n_test", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--img_size", type=int, default=IMG_SIZE)
    ap.add_argument("--max_overlap", type=float, default=None,
                    help="cap pairwise GT box IoU (None = legacy fixtures)")
    a = ap.parse_args()
    main(a.root, a.n_train, a.n_val, a.n_test, a.seed, a.img_size, a.max_overlap)
