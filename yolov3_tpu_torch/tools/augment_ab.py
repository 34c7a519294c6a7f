"""Augmentation/EMA/multi-scale value A/B.

Counterpart of the JAX package's ``tools/augment_ab.py``. Every training
extension the trainer ships beyond the reference's train.py (mosaic, HSV
jitter, EMA, multi-scale, SGD) is mechanically tested; this tool measures
whether each one moves val mAP, the same bar the QAT A/B applies
(``tools/qat_ab.py``).

The regime is a deliberately SMALL corpus (default 512 train images @416²)
where the model cannot saturate: on the 4096-image convergence corpus there
is no headroom for an augmentation to show an effect. Each variant trains
otherwise identically (same seed, corpus and trainer config, through
``python -m yolov3_tpu_torch.tools.train_convergence`` in a process of its
own) and is evaluated with the serving predictor on the same held-out val
split.

Variants:
  plain        no extension (the reference's training regime + cosine/bf16)
  mosaic       augmentation {mosaic: 0.5} (YOLOv4-style 4-neighbor composite)
  hsv          augmentation {hue: .1, saturation: 1.5, exposure: 1.5} (Darknet HSV)
  ema          ema {decay: 0.999} — mAP evaluated on the EMA shadow weights
               (the sibling ``<ckpt>.ema`` checkpoint the trainer writes)
  multi_scale  {sizes: [<=image_size...], mode: cycle} — device-side
               downscales of the staged corpus
  sgd          optimizer {sgd, momentum .9, nesterov} — Darknet's regime
               against the reference's Adam (same cosine LR)
  all          mosaic + HSV + EMA together

Writes <out_root>/augment_ab.json with one mAP@0.5 row per variant.

Usage (relative paths resolve against the repo root):
  python -m yolov3_tpu_torch.tools.augment_ab [--epochs 300] [--only plain,ema] [--eval_only]
CPU smoke: --device cpu --n_train 64 --n_val 16 --image_size 96 --epochs 2 --batch_size 8
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from ..data.native_build import ensure_native_library
from ..device import resolve_device
from .train_convergence import REPO, evaluate_map50, stale_regime


def variants(scales):
    return [
        ("plain", [], None),
        ("mosaic", ["--augment", '{"mosaic": 0.5}'], None),
        ("hsv", ["--augment",
                 '{"hue": 0.1, "saturation": 1.5, "exposure": 1.5}'], None),
        ("ema", ["--extra", '{"ema": {"decay": 0.999}}'], "ema"),
        ("multi_scale", ["--extra", json.dumps({"multi_scale": {
                             "sizes": scales, "mode": "cycle"}})], None),
        ("sgd", ["--extra", '{"optimizer": {"type": "sgd", "momentum": 0.9,'
                            ' "nesterov": true}}'], None),
        # do the wins compose? mosaic+HSV+EMA together (the typical
        # "turn everything on" recipe a user would reach for)
        ("all", ["--augment",
                 '{"mosaic": 0.5, "hue": 0.1, "saturation": 1.5,'
                 ' "exposure": 1.5}',
                 "--extra", '{"ema": {"decay": 0.999}}'], "ema"),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.augment_ab")
    ap.add_argument("--model", default="yolov3_tiny")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--n_train", type=int, default=512)
    ap.add_argument("--n_val", type=int, default=256)
    ap.add_argument("--image_size", type=int, default=416)
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--out_root", default="output/augment_ab_torch")
    ap.add_argument("--only", default=None,
                    help="comma-separated variant subset")
    ap.add_argument("--eval_only", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise before any work
    os.chdir(REPO)
    # the decoding library, built once before the per-run processes start
    print(f":: {ensure_native_library().line()}", flush=True)

    data_root = args.data_root or f"output/shapes_ab{args.image_size}"
    stride = 32
    scales = sorted({max(stride * 3, args.image_size - 96),
                     max(stride * 3, args.image_size - 64), args.image_size})
    only = set(args.only.split(",")) if args.only else None

    model_config = f"config/models/{args.model}/model.yaml"
    rows = {}
    for name, extra_args, eval_sibling in variants(scales):
        if only and name not in only:
            continue
        out_dir = os.path.join(args.out_root, name)
        ckpt = os.path.join(out_dir, f"{args.model}.tf")
        # resume support: a variant whose training completed (checkpoint +
        # result.json both present) is not retrained, so an aborted sweep
        # costs only the unfinished variants on rerun. A completed run from a
        # DIFFERENT regime (other --epochs/--n_train/...) must retrain, not
        # silently mix into the table: the saved regime fields are compared.
        result_path = os.path.join(out_dir, "result.json")
        done = os.path.exists(ckpt + ".npz") and os.path.exists(result_path)
        if done:
            stale = stale_regime(result_path, {
                "epochs": args.epochs, "batch_size": args.batch_size,
                "n_train": args.n_train, "n_val": args.n_val,
                "image_size": args.image_size, "data_root": data_root})
            if stale:
                print(f":: {name}: stale checkpoint from a different regime "
                      f"{stale} — retraining", flush=True)
                done = False
        if not args.eval_only and not done:
            cmd = [sys.executable, "-m", "yolov3_tpu_torch.tools.train_convergence",
                   "--model", args.model, "--epochs", str(args.epochs),
                   "--batch_size", str(args.batch_size),
                   "--n_train", str(args.n_train),
                   "--n_val", str(args.n_val),
                   "--image_size", str(args.image_size),
                   "--data_root", data_root, "--out_dir", out_dir,
                   "--skip_eval"] + extra_args
            if args.device:
                cmd += ["--device", args.device]
            print("::", " ".join(cmd), flush=True)
            subprocess.run(cmd, check=True, cwd=REPO)
        eval_ckpt = ckpt + ".ema" if eval_sibling == "ema" else ckpt
        r = evaluate_map50(model_config, eval_ckpt, data_root,
                           args.image_size, device=args.device)
        run_meta = {}
        if os.path.exists(result_path):
            with open(result_path) as f:
                full = json.load(f)
            run_meta = {"wall_seconds": full.get("wall_seconds"),
                        "final_val_loss": full.get("val_loss", {}).get(str(args.epochs))}
        rows[name] = dict(map50=round(r["map50"], 4), **run_meta)
        print(json.dumps({"variant": name, **rows[name]}), flush=True)

    if "plain" in rows:
        base = rows["plain"]["map50"]
        for name in rows:
            rows[name]["delta_vs_plain"] = round(rows[name]["map50"] - base, 4)
    out = {"model": args.model, "image_size": args.image_size,
           "epochs": args.epochs, "batch_size": args.batch_size,
           "n_train": args.n_train, "n_val": args.n_val,
           "data_root": data_root, "rows": rows}
    os.makedirs(args.out_root, exist_ok=True)
    with open(os.path.join(args.out_root, "augment_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(rows), flush=True)
    return out


if __name__ == "__main__":
    main()
