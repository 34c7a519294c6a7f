"""Pets transfer-learning recipe (the reference's custom-dataset demo).

Counterpart of the JAX package's ``tools/pets_transfer.py``, with the same
command line plus ``--device``. Drives the bundled
``config/train_config_pets.yaml`` end to end through the port's trainer
(``apps/train_app.py::Train``): the transfer machinery
(``models/transfer.py``: ``transfer_list: [neck]`` loads backbone and neck
from ``--backbone_ckpt``, ``freeze_train_list`` keeps the backbone's weights,
``batch_norm_freeze_list`` runs BN in inference mode in backbone and neck) on
the Oxford-Pets-style by-breed COCO export (the bundled 48 + 16-image
``datasets/pets_mini/``; set ``PETS_DATA_ROOT`` for a full export). The heads
are fresh: the class count moves to the 38 lines of ``pets_breed.names``.
It then records the val-loss trend and evaluates the checkpoint's mAP@0.5
under bf16 and int8 serving on the val split
(``tools/int8_accuracy_gate.py::run_gate``).

The recipe, as the JAX tool's: early stopping with best-weights restore
(``--patience``, 0 disables), mosaic + HSV augmentation (``--no_augment``
drops it), the splits staged on the device as uint8 (``--no_device_dataset``
streams them), bf16 mixed precision, cosine LR; ``--freeze none`` loads the
same transferred weights and trains every sub-model.

``config/train_config_pets.yaml``'s own ``input_weights_path``
(``checkpoints/keras_coco_yolov3.tf``) is not in the repo: ``--backbone_ckpt``
names the checkpoint, a full-YOLOv3 ``.npz`` (``train_convergence --model
yolov3`` leaves one at the default path; ``cli convert`` makes one from a
Darknet ``yolov3.weights``). The default paths are the port's own
(``output/convergence_torch/yolov3/yolov3.tf``, ``output/pets_transfer_torch``),
apart from the JAX tool's. Relative paths resolve against the repo root; the
caller's working directory is restored on return.

Runs on the CUDA card unless given ``--device cpu``; with no card it raises
before any work. On the card every unfrozen BatchNorm layer of a train step
runs the BatchNorm-statistics kernel (K5) both ways, the gate's predictors the
suppression sweep (K1) and its int8 tier the int8 convolution kernels (K3, K6).

Usage:
  python -m yolov3_tpu_torch.tools.pets_transfer [--epochs 60]
      [--backbone_ckpt output/convergence_torch/yolov3/yolov3.tf]
      [--freeze config|none] [--no_augment] [--patience 0 to disable] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from ..device import resolve_device
from .train_convergence import REPO, EpochCapture

AUGMENT = {"mosaic": 0.5, "hue": 0.1, "saturation": 1.5, "exposure": 1.5}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.pets_transfer",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--backbone_ckpt", default="output/convergence_torch/yolov3/yolov3.tf")
    ap.add_argument("--image_size", type=int, default=None,
                    help="override the config's 416 (CPU smoke)")
    ap.add_argument("--no_device_dataset", action="store_true",
                    help="stream batches from the host instead of staging the "
                    "splits on the device (uint8)")
    ap.add_argument("--freeze", default="config", choices=["config", "none"],
                    help="'config': the bundled recipe (backbone frozen, "
                    "necks/heads train: the reference's demo). 'none': "
                    "load the same transferred weights but train every "
                    "sub-model (full fine-tune off the warm start)")
    ap.add_argument("--patience", type=int, default=12,
                    help="early-stopping patience on val_loss with "
                    "best-weights restore (0 disables)")
    ap.add_argument("--no_augment", action="store_true",
                    help="drop the mosaic+HSV recipe")
    ap.add_argument("--remat", default=False, action="store_true",
                    help="conv-output remat (for --freeze none at larger batch sizes)")
    ap.add_argument("--eval_max_images", type=int, default=256)
    ap.add_argument("--eval_score_threshold", type=float, default=0.05)
    ap.add_argument("--out_dir", default="output/pets_transfer_torch")
    ap.add_argument("--eval_only", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap, ap.parse_args(argv)


def train_config(args) -> dict:
    """The trainer's kwargs: ``config/train_config_pets.yaml`` with the JAX
    tool's updates, plus ``device``."""
    from ..config import load_yaml

    cfg = load_yaml("config/train_config_pets.yaml")
    cfg.update(
        epochs=args.epochs, batch_size=args.batch_size,
        output_checkpoints_path=os.path.join(args.out_dir, "yolov3_pets.tf"),
        early_stopping=args.patience > 0,
        early_stop_patience=args.patience,
        weights_save_peroid=10 ** 9, resume=False,
        mixed_precision=True, compilation_cache=True,
        remat="conv" if args.remat else False,
        lr_schedule={"type": "cosine", "warmup_epochs": 2,
                     "min_lr_fraction": 0.05},
    )
    if not args.no_augment:
        cfg["augmentation"] = dict(AUGMENT)
    if not args.no_device_dataset:
        cfg["device_dataset"] = {"dtype": "uint8"}
    cfg["transfer_learning_config"]["input_weights_path"] = args.backbone_ckpt
    if args.freeze == "none":
        # the same transfer load, nothing frozen: a full fine-tune off the
        # warm start (transfer_list still says which weights transfer)
        cfg["transfer_learning_config"]["freeze_train_list"] = ["none"]
        cfg["transfer_learning_config"]["batch_norm_freeze_list"] = ["none"]
    if args.image_size:
        cfg["image_size"] = args.image_size
    cfg["device"] = args.device
    return cfg


def run(ap, args) -> dict:
    ckpt_exists = any(os.path.exists(args.backbone_ckpt + suf)
                      for suf in ("", ".npz", ".index"))
    if not args.eval_only and not ckpt_exists:
        ap.error(
            f"backbone checkpoint {args.backbone_ckpt!r} not found: run "
            "`python -m yolov3_tpu_torch.tools.train_convergence --model yolov3` "
            "first (it leaves the converged checkpoint at the default path), or "
            "pass --backbone_ckpt <path> to an existing full-yolov3 checkpoint")

    os.makedirs(args.out_dir, exist_ok=True)
    cfg = train_config(args)
    ckpt = cfg["output_checkpoints_path"]
    capture = EpochCapture()
    result = {"recipe": {"freeze": args.freeze, "patience": args.patience,
                         "augment": None if args.no_augment else AUGMENT},
              "config": cfg}

    if not args.eval_only:
        from ..apps.train_app import Train

        trainer_log = logging.getLogger("yolov3_tpu_torch.apps.train_app")
        trainer_log.addHandler(capture)
        try:
            Train()(**cfg)
        finally:
            trainer_log.removeHandler(capture)
        result.update(train_loss=capture.series["train_loss"],
                      val_loss=capture.series["val_loss"])

    # mAP@0.5 + the int8 gate on the val split (38 classes, real photos);
    # with early stopping the checkpoint holds the best-val_loss weights
    from .int8_accuracy_gate import run_gate

    val = cfg["dataset_config"]["data_files"]["valid"]
    gate = run_gate(
        max_images=args.eval_max_images, image_size=cfg["image_size"],
        score_threshold=args.eval_score_threshold,
        model_config=cfg["model_config_file"], ckpt=ckpt,
        names=cfg["classes_name_file"], anchors_file=cfg["anchors_file"],
        val_images_dir=val["images_dir"], val_annotations=val["annotations"],
        device=args.device)
    result["int8_gate"] = gate
    with open(os.path.join(args.out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    vl = result.get("val_loss", {})
    print(json.dumps({"best_val_loss": min(vl.values()) if vl else None,
                      "stopped_epoch": max(vl) if vl else None,
                      "map50_bf16": gate["map50_bf16"],
                      "map50_int8": gate["map50_int8"],
                      "gate_pass": gate["gate_pass"]}), flush=True)
    return result


def main(argv=None) -> dict:
    """Train and gate; returns the dict written to ``<out_dir>/result.json``."""
    ap, args = parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise before any work
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return run(ap, args)
    finally:
        os.chdir(cwd)


if __name__ == "__main__":
    main()
