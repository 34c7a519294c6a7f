"""Model × eval-resolution mAP matrix.

Counterpart of the JAX package's ``tools/scale_matrix.py``, with the same
command line plus ``--device``, the same tables and the same JSON: evaluates
each trained flagship variant at each eval resolution through the port's
``tools/train_convergence.py::evaluate_map50`` (the serving predictor, bf16):

  variants (rows):
    single_scale_416   the 416-native flagship
    ms_per_epoch       multi_scale [320,416,608], one size per EPOCH
    ms_interval10      multi_scale [320,416,608], a size switch every 10 BATCHES
                       (Darknet's regime, ``interval: 10``)
    and their BN-recalibrated siblings (``tools/bn_recalibrate.py``: the same
    conv weights, running statistics recomputed at the named size)
  evals (columns):
    320 — shapes_conv608's val split at 320²
    416 — shapes_conv416's val split at 416²
    608 — shapes_conv608's val split at 608²

A missing checkpoint is a ``"missing": true`` row and a missing corpus a
``null`` cell, never skipped. The variants' checkpoints are the port's own
(``output/convergence_torch/...``, where ``train_convergence`` writes them),
apart from the JAX tool's; the corpora are shared (both generators write the
same bytes). Relative paths resolve against the repo root; the caller's
working directory is restored on return.

Runs on the CUDA card unless given ``--device cpu``; with no card it raises
before any work. On the card each evaluation's top-K NMS runs the suppression
sweep (K1).

Usage:
  python -m yolov3_tpu_torch.tools.scale_matrix [--out output/scale_matrix_torch.json]
      [--only single_scale_416,ms_interval10] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..device import resolve_device
from .train_convergence import REPO, evaluate_map50

MODEL_CONFIG = "config/models/yolov3/model.yaml"
VARIANTS = {
    "single_scale_416": "output/convergence_torch/yolov3/yolov3.tf",
    "ms_per_epoch": "output/convergence_torch/yolov3_ms/yolov3.tf",
    "ms_interval10": "output/convergence_torch/yolov3_msi/yolov3.tf",
    # the per-epoch+cal416 row isolates how much of its 416 deficit is BN
    # miscalibration; the single-scale+cal608 row separates the BN component
    # of the 608 collapse from the feature component
    "ms_per_epoch_cal416": "output/convergence_torch/yolov3_ms/yolov3.tf.cal416",
    "single_scale_416_cal608": "output/convergence_torch/yolov3/yolov3.tf.cal608",
    # interval-trained (scale-robust features, scale-blended BN) plus one
    # statistics sibling per trained resolution
    "ms_interval10_cal320": "output/convergence_torch/yolov3_msi/yolov3.tf.cal320",
    "ms_interval10_cal416": "output/convergence_torch/yolov3_msi/yolov3.tf.cal416",
    "ms_interval10_cal608": "output/convergence_torch/yolov3_msi/yolov3.tf.cal608",
}
EVALS = {
    # 320 evals resize the 608-native val split (the geometry the staged
    # multi-scale trainer used for its 320 batches)
    "320": ("output/shapes_conv608", 320),
    "416": ("output/shapes_conv416", 416),
    "608": ("output/shapes_conv608", 608),
}


def matrix(variants, evals, only=None, device=None) -> dict:
    """``{variant: row}``: each present checkpoint of ``variants`` evaluated
    at each column of ``evals`` (``{column: (data_root, image_size)}``)."""
    rows = {}
    for name, ckpt in variants.items():
        if only and name not in only:
            continue
        rows[name] = {"checkpoint": ckpt}
        if not os.path.exists(ckpt + ".npz"):
            rows[name]["missing"] = True
            print(json.dumps({"variant": name, "missing": True}), flush=True)
            continue
        for col, (data_root, size) in evals.items():
            if not os.path.isdir(os.path.join(data_root, "tfrecords", "val")):
                rows[name][f"map50_at_{col}"] = None
                continue
            t0 = time.time()
            r = evaluate_map50(MODEL_CONFIG, ckpt, data_root, size, device=device)
            rows[name][f"map50_at_{col}"] = round(r["map50"], 4)
            rows[name][f"eval_{col}_wall_s"] = round(time.time() - t0, 1)
            print(json.dumps({"variant": name, "eval": col,
                              "map50": rows[name][f"map50_at_{col}"]}), flush=True)
    return rows


def main(argv=None, variants=None, evals=None) -> dict:
    """Evaluate and write ``--out``; returns the dict written. ``variants`` /
    ``evals`` stand in for the tables (in-process callers)."""
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.scale_matrix")
    ap.add_argument("--out", default="output/scale_matrix_torch.json")
    ap.add_argument("--only", default=None, help="comma-separated variant subset")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise before any work
    variants = VARIANTS if variants is None else variants
    evals = EVALS if evals is None else evals
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        rows = matrix(variants, evals, set(args.only.split(",")) if args.only else None,
                      args.device)
        out = {"model_config": MODEL_CONFIG,
               "evals": {k: {"data_root": v[0], "image_size": v[1]} for k, v in evals.items()},
               "eval_score_threshold": 0.01,
               "rows": rows}
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    finally:
        os.chdir(cwd)
    print(json.dumps(rows), flush=True)
    return out


if __name__ == "__main__":
    main()
