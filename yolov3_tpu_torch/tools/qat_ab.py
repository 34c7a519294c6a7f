"""QAT accuracy A/B: does QAT buy int8 serving accuracy?

Counterpart of the JAX package's ``tools/qat_ab.py``. Trains three otherwise
identical models on the convergence corpus —
  plain        (qat: false)
  qat_weights  (qat: weights — STE fake-quant of conv kernels on the int8
                serving lattice)
  qat_full     (qat: full — + activation fake-quant on the int8_chain
                lattice)
— then evaluates EVERY checkpoint under EVERY serving tier (bf16, int8 PTQ,
int8_chain PTQ) on the held-out val split, and writes the mAP@0.5 matrix to
<out_root>/qat_ab_<model>.json. The question each row answers: "how much
mAP does this training mode lose when served quantized?"

Each training run is ``python -m yolov3_tpu_torch.tools.train_convergence``
in a process of its own (same corpus, trainer config and predictor-based
evaluator), so the A/B differs ONLY in the qat key; the evaluations run in
this process. ``--batch_size`` and ``--n_val`` go through to it (the JAX
tool leaves them at the recipe's defaults, 128 and 256), and ``--device``.

Usage (relative paths resolve against the repo root):
  python -m yolov3_tpu_torch.tools.qat_ab [--epochs 240] [--model yolov3_tiny]
  python -m yolov3_tpu_torch.tools.qat_ab --modes plain,qat_full
  python -m yolov3_tpu_torch.tools.qat_ab --eval_only   # reuse existing checkpoints
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

MODES = [("plain", "False"), ("qat_weights", "weights"), ("qat_full", "full")]
TIERS = [None, "int8", "int8_chain"]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.qat_ab")
    ap.add_argument("--model", default="yolov3_tiny")
    ap.add_argument("--epochs", type=int, default=240)
    ap.add_argument("--n_train", type=int, default=4096)
    ap.add_argument("--n_val", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--image_size", type=int, default=416)
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--out_root", default="output/convergence_torch")
    ap.add_argument("--eval_only", action="store_true")
    ap.add_argument("--modes", default=None,
                    help="comma-separated subset of plain,qat_weights,qat_full")
    ap.add_argument("--remat", default=None,
                    help="forwarded to train_convergence (full yolov3 at "
                         "B=128 needs 'conv' beside the staged corpus)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise before any work
    os.chdir(REPO)
    # the decoding library, built once before the per-run processes start
    print(f":: {ensure_native_library().line()}", flush=True)

    data_root = args.data_root or f"output/shapes_conv{args.image_size}"
    modes = ([m for m in MODES if m[0] in set(args.modes.split(","))]
             if args.modes else MODES)
    rows = {}
    for name, qat in modes:
        out_dir = (os.path.join(args.out_root, args.model) if name == "plain"
                   else os.path.join(args.out_root, f"{args.model}_{name}"))
        ckpt = os.path.join(out_dir, f"{args.model}.tf")
        # the plain row may reuse an existing checkpoint (the recipe's own
        # run) — but only from the SAME regime; a leftover from different
        # epochs/corpus args must retrain, not contaminate the A/B
        plain_reusable = name == "plain" and os.path.exists(ckpt + ".npz")
        if plain_reusable:
            stale = stale_regime(os.path.join(out_dir, "result.json"), {
                "epochs": args.epochs, "n_train": args.n_train, "n_val": args.n_val,
                "batch_size": args.batch_size, "image_size": args.image_size,
                "data_root": data_root})
            if stale:
                print(f":: plain: stale checkpoint from a different regime "
                      f"{stale} — retraining", flush=True)
                plain_reusable = False
        if not args.eval_only and not plain_reusable:
            # a process per run: the card's caches and the staged corpus of
            # one training run would otherwise crowd the next's memory
            cmd = [sys.executable, "-m", "yolov3_tpu_torch.tools.train_convergence",
                   "--model", args.model, "--epochs", str(args.epochs),
                   "--n_train", str(args.n_train), "--n_val", str(args.n_val),
                   "--batch_size", str(args.batch_size),
                   "--image_size", str(args.image_size),
                   "--data_root", data_root, "--out_dir", out_dir,
                   "--qat", qat]
            if args.remat:
                cmd += ["--remat", args.remat]
            if args.device:
                cmd += ["--device", args.device]
            print("::", " ".join(cmd), flush=True)
            subprocess.run(cmd, check=True, cwd=REPO)

        model_config = f"config/models/{args.model}/model.yaml"
        rows[name] = {}
        for tier in TIERS:
            r = evaluate_map50(model_config, ckpt, data_root,
                               args.image_size, quantize=tier, device=args.device)
            rows[name][tier or "bf16"] = round(r["map50"], 4)
            print(json.dumps({"train_mode": name, "serve_tier": tier or "bf16",
                              "map50": round(r["map50"], 4)}), flush=True)

    for name in rows:
        base = rows[name]["bf16"]
        rows[name]["int8_delta"] = round(rows[name]["int8"] - base, 4)
        rows[name]["int8_chain_delta"] = round(
            rows[name]["int8_chain"] - base, 4)
    out = {"model": args.model, "image_size": args.image_size,
           "epochs": args.epochs, "n_train": args.n_train, "n_val": args.n_val,
           "batch_size": args.batch_size, "data_root": data_root, "matrix": rows}
    os.makedirs(args.out_root, exist_ok=True)
    path = os.path.join(args.out_root, f"qat_ab_{args.model}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["matrix"]), flush=True)
    return out


if __name__ == "__main__":
    main()
