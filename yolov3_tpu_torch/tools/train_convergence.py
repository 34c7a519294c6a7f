"""Full-resolution training-to-convergence recipe.

Counterpart of the JAX package's ``tools/train_convergence.py``, with the same
command line plus ``--device``:
  1. generates a seeded shapes corpus at the target resolution
     (``tools/make_toy_dataset.py``, default 2048 train + 256 val @416²),
  2. trains the requested model family from scratch on it with the port's
     trainer (``apps/train_app.py::Train``: device-resident uint8 dataset,
     cosine LR, bf16 mixed precision — all config keys, no code path of its
     own),
  3. evaluates mAP@0.5 on the held-out val split with the SAME predictor
     the inference app serves (forward + decode + NMS, ``make_predictor``),
  4. writes <out>/result.json {loss curves, wall img/s, mAP@0.5} and leaves
     <out>/<model>.tf.npz for the quantization tiers (``tools/qat_ab.py``).

Runs on the CUDA card unless given ``--device cpu``; with no card it raises.
On the card every BatchNorm of a train step runs the BatchNorm-statistics
kernel (K5) both ways, the predictor's top-K NMS the suppression sweep (K1),
and the int8 tiers the int8 convolution kernels (K3, K6).

The default ``--out_dir`` is ``output/convergence_torch/<model>``, apart
from the JAX tool's ``output/convergence/<model>``: neither tool reuses the
other's checkpoint. The corpus under ``--data_root`` may be shared: both
generators write the same bytes.

Usage (relative paths resolve against the repo root):
  python -m yolov3_tpu_torch.tools.train_convergence --model yolov3_tiny
  python -m yolov3_tpu_torch.tools.train_convergence --model yolov3_tiny --n_train 4096 --epochs 240
CPU smoke: --device cpu --n_train 64 --n_val 16 --image_size 96 --epochs 2 --batch_size 8
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import re
import resource
import time

import numpy as np
import torch

from ..device import resolve_device

REPO = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def ensure_dataset(root, n_train, n_val, image_size, seed, max_overlap):
    """Generate the corpus under ``root`` unless its ``meta.json`` says it
    is already this one (the same marker the JAX tool writes)."""
    marker = os.path.join(root, "meta.json")
    want = {"n_train": n_train, "n_val": n_val,
            "image_size": image_size, "seed": seed,
            "max_overlap": max_overlap, "split_rng": 1}
    if os.path.exists(marker):
        with open(marker) as f:
            if json.load(f) == want:
                return
    from .make_toy_dataset import main as make_dataset

    make_dataset(root, n_train=n_train, n_val=n_val, n_test=0,
                 seed=seed, img_size=image_size, max_overlap=max_overlap)
    with open(marker, "w") as f:
        json.dump(want, f)


def stale_regime(result_path, regime):
    """``{key: (saved, wanted)}`` for each key of ``regime`` that the run's
    saved ``result.json`` (absent: nothing saved) does not match: a
    checkpoint from another regime is retrained, never reused."""
    prev = {}
    if os.path.exists(result_path):
        with open(result_path) as f:
            prev = json.load(f)
    return {k: (prev.get(k), v) for k, v in regime.items() if prev.get(k) != v}


class EpochCapture(logging.Handler):
    """Collect the trainer's per-epoch train/val loss + throughput lines."""

    PATTERNS = {
        "train_loss": re.compile(r"epoch (\d+): train_loss ([\d.eE+-]+)"),
        "val_loss": re.compile(r"epoch (\d+): val_loss ([\d.eE+-]+)"),
        "img_per_sec": re.compile(r"epoch (\d+): \d+ steps in [\d.]+s \(([\d.]+) img/s\)"),
    }

    def __init__(self):
        super().__init__()
        self.series = {k: {} for k in self.PATTERNS}

    def emit(self, record):
        msg = record.getMessage()
        for key, pat in self.PATTERNS.items():
            m = pat.search(msg)
            if m:
                self.series[key][int(m.group(1))] = float(m.group(2))


def evaluate_map50(model_config, ckpt_path, data_root, image_size,
                   batch_size=32, score_threshold=0.01, quantize=None, device=None):
    """mAP@0.5 on the held-out val tfrecords via the serving predictor.

    ``quantize``: None (bf16 serving) or 'int8'/'int8_chain' — the PTQ
    serving tiers, calibrated on the first 8 val images. The last batch is
    padded with zero images to ``batch_size``, as the JAX tool pads to its
    compiled batch. Runs on the card unless ``device`` is ``cpu``."""
    from ..apps.inference_app import make_predictor
    from ..config import get_anchors, read_class_names
    from ..data.tfrecord import parse_tfrecords
    from ..eval.detections_evaluator import APAccumulator
    from ..io.resolve import load_weights
    from ..models import init_model, parse_model_config

    names_file = os.path.join(data_root, "class.names")
    nclasses = len(read_class_names(names_file))
    spec = parse_model_config(model_config, nclasses=nclasses)
    anchors_name = ("anchors_tiny.txt" if "tiny" in os.path.basename(
        os.path.dirname(model_config) or model_config) else "anchors.txt")
    anchors = get_anchors(os.path.join(data_root, "anchors", anchors_name))
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    params, state = load_weights(spec, params, state, ckpt_path)

    val_dir = os.path.join(data_root, "tfrecords", "val")
    kwargs = dict(compute_dtype=torch.bfloat16)
    if quantize:
        calib = np.stack([np.asarray(im) for im, _ in itertools.islice(
            parse_tfrecords(val_dir, image_size, 100, names_file), 8)])
        kwargs = dict(quantize=quantize, calibration_batches=[calib.astype(np.float32)])
    predict = make_predictor(spec, params, state, anchors, nclasses, 100,
                             0.5, score_threshold, device=device, **kwargs)

    acc = APAccumulator(nclasses=nclasses)
    batch_imgs, batch_lbls, n_images = [], [], 0

    def flush():
        nonlocal batch_imgs, batch_lbls
        if not batch_imgs:
            return
        n = len(batch_imgs)
        while len(batch_imgs) < batch_size:  # pad to the batch the tiers are held at
            batch_imgs.append(np.zeros_like(batch_imgs[0]))
            batch_lbls.append(np.zeros_like(batch_lbls[0]))
        imgs = np.stack(batch_imgs).astype(np.float32)
        bboxes, cls, scores, selected, nvalid = (t.cpu().numpy() for t in predict(imgs))
        for i in range(n):
            nv = int(nvalid[i])
            sel = selected[i, :nv]
            lb = batch_lbls[i]
            gt = lb[lb[:, 4] > 0]
            acc.add_image(bboxes[i][sel], cls[i][sel], scores[i][sel],
                          gt[:, :4], gt[:, 5].astype(np.int32))
        batch_imgs, batch_lbls = [], []

    for im, lb in parse_tfrecords(val_dir, image_size, 100, names_file):
        batch_imgs.append(np.asarray(im))
        batch_lbls.append(np.asarray(lb))
        n_images += 1
        if len(batch_imgs) == batch_size:
            flush()
    flush()
    per_class, mean_ap = acc.compute()
    return {"map50": float(mean_ap),
            "per_class_ap50": [float(a) for a in np.asarray(per_class)],
            "val_images": n_images}


def train_config(model, data_root, ckpt, args):
    """The trainer's kwargs of the recipe, the JAX tool's own keys (its
    ``compilation_cache`` only logs that it has no effect here) plus
    ``device``."""
    tiny = model == "yolov3_tiny"
    cfg = dict(
        dataset_config={
            "input_data_source": "tfrecords",
            "tfrecords": {
                "train": os.path.join(data_root, "tfrecords", "train"),
                "valid": os.path.join(data_root, "tfrecords", "val"),
            },
        },
        classes_name_file=os.path.join(data_root, "class.names"),
        anchors_file=os.path.join(
            data_root, "anchors",
            "anchors_tiny.txt" if tiny else "anchors.txt"),
        max_dataset_examples=None,
        max_bboxes=10,
        model_config_file=f"config/models/{model}/model.yaml",
        image_size=args.image_size,
        training_mode="fit",
        batch_size=args.batch_size,
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        early_stopping=False,
        early_stop_patience=13,
        weights_save_peroid=10 ** 9,
        output_checkpoints_path=ckpt,
        transfer_learning_config={
            "transfer_list": ["none"], "freeze_train_list": ["none"],
            "batch_norm_freeze_list": ["none"], "input_weights_path": ckpt,
        },
        debug_mode=False,
        render_dataset_example=False,
        resume=False,
        seed=args.seed,
        shuffle=True,
        mixed_precision=True,
        lr_schedule={"type": "cosine", "warmup_epochs": 2,
                     "min_lr_fraction": 0.05},
        qat=args.qat,
        remat=args.remat,
        compilation_cache=True,
        device=args.device,
    )
    if args.feed == "device":
        cfg["device_dataset"] = {"dtype": "uint8"}
    else:
        cfg["stream_workers"] = args.stream_workers
    if args.augment:
        cfg["augmentation"] = json.loads(args.augment)
    if args.extra:
        cfg.update(json.loads(args.extra))
    return cfg


def qat_arg(s):
    v = s.strip().lower()
    if v in ("false", "0", ""):
        return False
    if v in ("true", "1"):
        return "weights"
    if v not in ("weights", "activations", "full"):
        raise argparse.ArgumentTypeError(
            f"--qat must be false/true/weights/activations/full, got {s!r}")
    return v


def remat_arg(s):
    v = s.strip().lower()
    if v in ("false", "0", ""):
        return False
    if v in ("true", "1"):
        return True
    if v != "conv":
        raise argparse.ArgumentTypeError(
            f"--remat takes false/true/conv, got {s!r}")
    return "conv"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.train_convergence",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="yolov3_tiny",
                    choices=["yolov3_tiny", "yolov3", "yolov3_spp"])
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--image_size", type=int, default=416)
    ap.add_argument("--n_train", type=int, default=2048)
    ap.add_argument("--n_val", type=int, default=256)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--max_overlap", type=float, default=0.15,
                    help="cap pairwise GT IoU in the generated corpus "
                         "(heavy occlusion caps achievable mAP)")
    ap.add_argument("--learning_rate", type=float, default=1e-3)
    ap.add_argument("--data_root", default=None,
                    help="default: output/shapes_conv<image_size>")
    ap.add_argument("--out_dir", default=None,
                    help="default: output/convergence_torch/<model>")
    ap.add_argument("--qat", default=False, type=qat_arg,
                    help="trainer qat mode (false/true/'weights'/'activations'/'full')")
    ap.add_argument("--remat", nargs="?", const=True, default=False, type=remat_arg,
                    help="rematerialize activations: bare flag/true = checkpoint "
                         "whole sub-models; 'conv' = save conv outputs, recompute "
                         "only the BN/leaky/pool tail")
    ap.add_argument("--feed", default="device", choices=["device", "stream"],
                    help="'device': stage the whole corpus on the card as uint8 "
                         "(device_dataset); 'stream': batched host streaming")
    ap.add_argument("--stream_workers", type=int, default=8,
                    help="decode threads for --feed stream")
    ap.add_argument("--augment", default=None,
                    help="augmentation keys as JSON, e.g. "
                         '\'{"hsv": {"hue": 0.1}}\'')
    ap.add_argument("--extra", default=None,
                    help="JSON dict of extra trainer config keys merged "
                         "last (e.g. '{\"ema\": {\"decay\": 0.999}}' or "
                         "'{\"multi_scale\": {\"sizes\": [320, 416]}}' — "
                         "used by tools/augment_ab.py)")
    ap.add_argument("--eval_only", action="store_true",
                    help="skip training; evaluate the existing checkpoint")
    ap.add_argument("--skip_eval", action="store_true",
                    help="train only (feed-mode timing runs)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the recipe; returns the result dict it writes to result.json."""
    args = parse_args(argv)
    dev = resolve_device(args.device)  # no card and no --device cpu: raise before any work
    os.chdir(REPO)

    data_root = args.data_root or f"output/shapes_conv{args.image_size}"
    out_dir = args.out_dir or os.path.join("output", "convergence_torch", args.model)
    os.makedirs(out_dir, exist_ok=True)
    ensure_dataset(data_root, args.n_train, args.n_val, args.image_size,
                   args.seed, args.max_overlap)

    model_config = f"config/models/{args.model}/model.yaml"
    ckpt = os.path.join(out_dir, f"{args.model}.tf")
    capture = EpochCapture()
    wall = None

    if not args.eval_only:
        from ..apps.train_app import Train

        cfg = train_config(args.model, data_root, ckpt, args)
        with open(os.path.join(out_dir, "train_config.json"), "w") as f:
            json.dump(cfg, f, indent=1)
        trainer_log = logging.getLogger("yolov3_tpu_torch.apps.train_app")
        trainer_log.addHandler(capture)
        try:
            t0 = time.time()
            Train()(**cfg)
            wall = time.time() - t0
        finally:
            trainer_log.removeHandler(capture)

    result = {"model": args.model, "image_size": args.image_size,
              "data_root": data_root, "eval_score_threshold": 0.01,
              "n_train": args.n_train, "n_val": args.n_val,
              "max_overlap": args.max_overlap,
              "batch_size": args.batch_size, "epochs": args.epochs,
              "feed": args.feed, "remat": args.remat, "qat": args.qat,
              "augment": args.augment and json.loads(args.augment),
              "extra": args.extra and json.loads(args.extra),
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "wall_seconds": wall,
              # ru_maxrss is in KiB on Linux: the host's peak, corpus decode included
              "host_peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
              "train_loss": capture.series["train_loss"],
              "val_loss": capture.series["val_loss"],
              "img_per_sec": capture.series["img_per_sec"]}
    if not args.skip_eval:
        print("evaluating mAP@0.5 on the held-out val split ...", flush=True)
        result["eval"] = evaluate_map50(model_config, ckpt, data_root,
                                        args.image_size, device=args.device)
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"model": args.model,
                      "map50": result.get("eval", {}).get("map50"),
                      "final_val_loss":
                          capture.series["val_loss"].get(args.epochs),
                      "wall_seconds": wall}), flush=True)
    return result


if __name__ == "__main__":
    main()
