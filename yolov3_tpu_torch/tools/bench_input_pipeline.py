"""Host input-pipeline headroom for training: the streaming TFRecord
pipeline alone — framing scan, proto decode, JPEG decode + resize (the
native GIL-free core where it is built), label assembly and batch stacking —
at the shape the train step consumes.

Counterpart of the JAX package's ``tools/bench_input_pipeline.py``, over the
port's ``data/pipeline.py`` and ``data/tfrecord.py``, with its flags:

    python -m yolov3_tpu_torch.tools.bench_input_pipeline
        [--data_root output/shapes_conv416] [--image_size 416] [--batch 128]
        [--workers 1 2 4 8] [--max_images 1024] [--target IMG_PER_S] [--batched]

Host only: it touches no device. Prints one JSON line per worker count and a
verdict line, which also names the decode tier that ran (``native``: the
C++ core of ``native/``, built at first use where a compiler is; else
``python``). ``--target`` is the img/s of the train step the host must feed,
measured on the card (``profile_train``, or ``train_convergence``'s trained
img/s); it has no default, and without it the verdict line reports the best
rate with ``"target_img_per_sec": null``. ``--batched`` takes the zero-copy
path (``tfrecord.stream_batches``) instead of the per-example ``Batcher``.
A relative ``--data_root`` resolves against the repository root.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time

import numpy as np

from . import _measure as M


def bench_stream(data_root, image_size, batch, workers, max_images, batched=False):
    """One pass over ``data_root``'s ``tfrecords/train`` after a warm pass →
    (img/s, images, checksum): the checksum adds each batch's first pixel
    value and first label value, as the JAX tool's."""
    from ..data.pipeline import Batcher, Dataset
    from ..data.tfrecord import parse_tfrecords, stream_batches

    train_dir = os.path.join(data_root, "tfrecords", "train")
    names = os.path.join(data_root, "class.names")

    if batched:
        def batches():
            return itertools.islice(
                stream_batches(train_dir, image_size, 10, batch, class_file=names,
                               num_workers=workers),
                max_images // batch)
    else:
        def gen():
            n = 0
            for ex in parse_tfrecords(train_dir, image_size, 10, names, num_workers=workers):
                yield ex
                n += 1
                if n >= max_images:
                    return

        def batches():
            return Batcher(Dataset(gen), batch)

    for _ in batches():  # warm the page cache and the thread pool
        pass
    t0 = time.perf_counter()
    n_img, checksum = 0, 0.0
    for images, labels in batches():
        n_img += images.shape[0]
        checksum += float(images[0, 0, 0, 0]) + float(labels[0, 0, 0])
    dt = time.perf_counter() - t0
    if not np.isfinite(checksum):
        raise AssertionError(f"bench_input_pipeline: non-finite checksum {checksum}")
    return n_img / dt, n_img, checksum


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.bench_input_pipeline")
    ap.add_argument("--data_root", default="output/shapes_conv416")
    ap.add_argument("--image_size", type=int, default=416)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--max_images", type=int, default=1024)
    ap.add_argument("--target", type=float, default=None,
                    help="the train step's img/s on the card that the host must beat")
    ap.add_argument("--batched", action="store_true",
                    help="the zero-copy batched path (tfrecord.stream_batches)")
    args = ap.parse_args(argv)
    data_root = M.repo_path(args.data_root)
    best, lines = 0.0, []
    for w in args.workers:
        rate, n, checksum = bench_stream(data_root, args.image_size, args.batch, w,
                                         args.max_images, batched=args.batched)
        best = max(best, rate)
        line = {"workers": w, "img_per_sec": round(rate, 1), "images": n, "batch": args.batch,
                "image_size": args.image_size,
                "path": "batched" if args.batched else "per-example"}
        lines.append(dict(line, checksum=checksum))
        print(json.dumps(line), flush=True)
    if args.target is None:
        verdict = {"verdict": "no_target", "best_img_per_sec": round(best, 1),
                   "target_img_per_sec": None, "headroom_x": None}
    else:
        verdict = {"verdict": "feeds_train_step" if best > args.target else "HOST_BOUND",
                   "best_img_per_sec": round(best, 1), "target_img_per_sec": args.target,
                   "headroom_x": round(best / args.target, 2)}
    from ..data import native

    verdict["decode"] = "native" if native.available() else "python"
    print(json.dumps(verdict), flush=True)
    return dict(verdict, rows=lines, host_cpus=os.cpu_count())


if __name__ == "__main__":
    main()
