"""k-means anchor generation (the reference's utilities/create_yolov3_anchors.py).

Counterpart of the JAX package's ``utilities/create_yolov3_anchors.py``, with
the same command line, YAML schema and output: cluster the ground-truth box
(w, h) pairs of a TFRecords directory or a COCO-JSON file, sort the centres
ascending by area and save them as CSV with ``np.savetxt``. Degenerate boxes
(zero extent in either dimension) are dropped.

The clustering is sklearn's ``KMeans`` where sklearn imports, else the numpy
Lloyd k-means below (k-means++ init, seeded): the JAX utility's choice, so
that both give the same file on the same machine. It stays numpy on the host.
A host tool: it touches no device.

The config's paths are taken as written, relative to the working directory,
as the JAX utility takes them: the bundled ``utilities/create_anchors_config.yaml``
holds ``../datasets/...`` paths, so run it from ``utilities/``:
  cd utilities && python -m yolov3_tpu_torch.tools.create_yolov3_anchors \\
      --config create_anchors_config.yaml
(with the repo root on ``PYTHONPATH``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.tfrecord import iter_tfrecord_files, iter_tfrecord_records, parse_example


def collect_wh_tfrecords(tfrecords_dir, limit=None):
    wh = []
    count = 0
    for path in iter_tfrecord_files(tfrecords_dir):
        for record in iter_tfrecord_records(path):
            ex = parse_example(record)
            xmin = np.asarray(ex.get("image/object/bbox/xmin", []), np.float32)
            ymin = np.asarray(ex.get("image/object/bbox/ymin", []), np.float32)
            xmax = np.asarray(ex.get("image/object/bbox/xmax", []), np.float32)
            ymax = np.asarray(ex.get("image/object/bbox/ymax", []), np.float32)
            w, h = xmax - xmin, ymax - ymin
            # a zero-extent box in EITHER dimension is degenerate: it would
            # seed a ~zero anchor and NaN the wh-IoU assignment at train time
            keep = (w > 0) & (h > 0)
            wh.append(np.stack([w[keep], h[keep]], axis=-1))
            count += 1
            if limit and count >= limit:
                return np.concatenate(wh)
    return np.concatenate(wh) if wh else np.zeros((0, 2), np.float32)


def collect_wh_data_files(annotations_path, limit=None):
    with open(annotations_path) as f:
        annotations = json.load(f)
    sizes = {im["id"]: (im["width"], im["height"]) for im in annotations["images"]}
    wh = []
    for annot in annotations["annotations"][: limit or None]:
        iw, ih = sizes[annot["image_id"]]
        _, _, w, h = annot["bbox"]
        if w > 0 and h > 0:
            wh.append([w / iw, h / ih])
    return np.asarray(wh, np.float32)


def kmeans(points, k, iters=300, seed=0):
    """Plain numpy Lloyd k-means with k-means++ init (deterministic)."""
    rng = np.random.RandomState(seed)
    n = len(points)
    centers = points[rng.randint(n)][None]
    for _ in range(1, k):
        d2 = ((points[:, None] - centers[None]) ** 2).sum(-1).min(-1)
        total = d2.sum()
        if total <= 0:
            # fewer distinct points than clusters: every point is already a
            # center; uniform picks instead of a zero-probability
            # np.random.choice, and the Lloyd iterations dedupe harmlessly
            centers = np.concatenate([centers, points[rng.randint(n)][None]])
            continue
        centers = np.concatenate([centers, points[rng.choice(n, p=d2 / total)][None]])
    for _ in range(iters):
        assign = ((points[:, None] - centers[None]) ** 2).sum(-1).argmin(-1)
        new = np.stack(
            [points[assign == i].mean(0) if (assign == i).any() else centers[i] for i in range(k)]
        )
        if np.allclose(new, centers):
            break
        centers = new
    return centers


def create_yolo_anchors(wh, n_clusters):
    try:
        from sklearn.cluster import KMeans

        centers = KMeans(n_clusters=n_clusters, n_init=10, random_state=0).fit(wh).cluster_centers_
    except ImportError:
        centers = kmeans(wh, n_clusters)
    # sort ascending by area (reference sort_anchors)
    return centers[(centers[:, 0] * centers[:, 1]).argsort()].astype(np.float32)


def main(argv=None):
    """Cluster and save; returns the anchors array written."""
    parser = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.create_yolov3_anchors")
    parser.add_argument("--config", type=str, default="create_anchors_config.yaml",
                        help="yaml config file")
    args = parser.parse_args(argv)
    from ..config import load_yaml  # ${VAR:-default} expansion

    config = load_yaml(args.config)

    limit = config.get("limit")
    if isinstance(limit, str):  # the reference's YAML uses the literal string 'None'
        limit = None
    if config["input_data_source"] == "tfrecords":
        wh = collect_wh_tfrecords(config["tfrecords"]["tfrecords_dir"], limit)
    else:
        wh = collect_wh_data_files(config["data_files"]["annotations"], limit)

    anchors = create_yolo_anchors(wh, config["n_clusters"])
    out = config["anchors_out_file"]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savetxt(out, anchors, delimiter=",")
    print(f"anchors saved to {out}:\n{anchors}")
    return anchors


if __name__ == "__main__":
    main()
