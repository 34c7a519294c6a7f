"""Recalibrate BatchNorm running statistics at a target serving resolution.

Counterpart of the JAX package's ``tools/bn_recalibrate.py``. BN running
means/variances are a property of the activation distribution, which shifts
with input resolution (and, after a short run at momentum 0.99, still hold
most of their init). AdaBN-style recalibration fixes the statistics without
touching a single weight: run k train-mode forward passes over the train
split at the TARGET size and replace the running statistics with the average
batch statistics.

Mechanics, the JAX package's algebra: ``apply_model(train=True)`` returns the
post-EMA state (new = m*old + (1-m)*batch), so each batch's statistics are
recovered as batch = (new - m*old) / (1-m) and averaged across batches (mean
of batch means; mean of batch variances). Both packages compute the same
estimator this way. On the card each BN layer's statistics are one forward
launch of the BatchNorm-statistics kernel (K5, ``ops/cuda/bn_stats.py``);
nothing is differentiated.

Writes ``<ckpt>.cal<size>`` (a normal checkpoint; params byte-identical to
the input's).

Usage (relative paths resolve against the repo root):
  python -m yolov3_tpu_torch.tools.bn_recalibrate --ckpt build/smoke_train/fp32/yolov3_toy.tf \\
      --data_root datasets/shapes_toy --image_size 416 [--batches 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..models.network import apply_model, to_device
from ..tree import tree_map


def recalibrate(spec, params, state, batches_iter, momentum, device=None):
    """Return ``(state, n)``: the BN running statistics replaced by the
    batch statistics averaged over the ``n`` batches of ``batches_iter``
    ((B, H, W, 3) float images), as CPU tensors. Runs on the card unless
    ``device`` is ``cpu``."""
    dev = resolve_device(device)
    params, state = to_device(params, dev), to_device(state, dev)
    acc, n = None, 0
    with torch.no_grad():
        for images in batches_iter:
            x = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
            _, new_state = apply_model(spec, params, state, x, train=True)
            batch_stat = tree_map(lambda new, old: (new - momentum * old) / (1.0 - momentum),
                                  new_state, state)
            acc = batch_stat if acc is None else tree_map(torch.add, acc, batch_stat)
            n += 1
    if n == 0:
        raise ValueError("no calibration batches — check data_root/split")
    return tree_map(lambda a: (a / n).cpu(), acc), n


def tfrecord_batches(data_root, split, image_size, batch_size, batches):
    """Up to ``batches`` (batch_size, image_size, image_size, 3) f32 arrays
    of ``<data_root>/tfrecords/<split>``; a last partial batch is dropped."""
    from ..data.tfrecord import parse_tfrecords

    names_file = os.path.join(data_root, "class.names")
    buf, yielded = [], 0
    src = os.path.join(data_root, "tfrecords", split)
    for im, _ in parse_tfrecords(src, image_size, 10, names_file):
        buf.append(np.asarray(im))
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf, yielded = [], yielded + 1
            if yielded >= batches:
                return


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.bn_recalibrate")
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint path (the .tf stem)")
    ap.add_argument("--model_config", default="config/models/yolov3/model.yaml")
    ap.add_argument("--data_root", required=True,
                    help="corpus root (class.names + tfrecords/<split>)")
    ap.add_argument("--split", default="train",
                    help="stats are a train-set property; val only for smoke")
    ap.add_argument("--image_size", type=int, required=True)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--out", default=None,
                    help="default: <ckpt>.cal<image_size>")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    os.chdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

    from ..config import read_class_names
    from ..io.resolve import load_weights, save_weights
    from ..models import init_model, parse_model_config
    from ..models.layers import BN_MOMENTUM

    nclasses = len(read_class_names(os.path.join(args.data_root, "class.names")))
    spec = parse_model_config(args.model_config, nclasses=nclasses)
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    params, state = load_weights(spec, params, state, args.ckpt)

    batches = tfrecord_batches(args.data_root, args.split, args.image_size,
                               args.batch_size, args.batches)
    new_state, n = recalibrate(spec, params, state, batches, BN_MOMENTUM, device=args.device)
    out = args.out or f"{args.ckpt}.cal{args.image_size}"
    save_weights(spec, params, new_state, out)
    print(json.dumps({"out": out, "batches": n,
                      "image_size": args.image_size,
                      "batch_size": args.batch_size}))


if __name__ == "__main__":
    main()
