"""Command line of the port: ``python -m yolov3_tpu_torch.apps.cli <command> …``
with the commands ``serve``, ``train``, ``evaluate``, ``inference``,
``convert`` and ``export``.

``serve_main`` / ``train_main`` / ``evaluate_main`` / ``inference_main`` /
``convert_main`` take the same arguments without the subcommand. The config
files are the JAX package's ``serve_config.yaml``, ``train_config.yaml``,
``evaluate_config.yaml``, ``detect_config.yaml`` and
``utilities/convert_config.yaml`` schemas (``export`` takes a detect or serve
config, as ``utilities/export_serving_artifact.py`` does); ``--device cpu``
runs the plain PyTorch path on the CPU instead of the card. ``export`` has
``--platforms`` in its place: it builds on the card when ``cuda`` is among
them.
"""

from __future__ import annotations

import argparse
import logging


def _device_arg(parser: argparse.ArgumentParser):
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")


def _serve_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config", type=str, default="config/serve_config.yaml",
                        help="yaml config file")
    _device_arg(parser)


def _train_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config", type=str, default="config/train_config.yaml",
                        help="yaml config file")
    _device_arg(parser)


def _inference_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config", type=str, default="config/detect_config.yaml",
                        help="yaml config file")
    _device_arg(parser)


def _convert_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config", type=str, default="utilities/convert_config.yaml",
                        help="yaml config file")
    _device_arg(parser)


def _export_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config", required=True,
                        help="detect/serve config yaml (model + NMS keys)")
    parser.add_argument("--out", required=True, help="output artifact path (a zip)")
    parser.add_argument("--platforms", default="cpu,cuda",
                        help="comma-separated platforms to export a program for (cpu, cuda)")


def _evaluate_args(parser: argparse.ArgumentParser):
    parser.add_argument("--evaluate_config", type=str, default="config/evaluate_config.yaml")
    parser.add_argument("--detect_config", type=str, default="config/detect_config.yaml")
    parser.add_argument("--max_eval_images", type=int, default=None,
                        help="limit evaluated images (reference hardcodes 20)")
    parser.add_argument("--no_map", action="store_true", help="skip mAP@0.5 computation")
    parser.add_argument("--coco_map", action="store_true",
                        help="report COCO-style mAP@[.5:.95] (10 IoU thresholds)")
    _device_arg(parser)


def _config(args) -> dict:
    from ..config import load_yaml

    cfg = load_yaml(args.config)
    if args.device is not None:
        cfg["device"] = args.device
    return cfg


def _serve(args):
    from .serve_app import Serve

    logging.basicConfig(level=logging.INFO)
    Serve()(**_config(args))


def _train(args):
    from .train_app import Train

    logging.basicConfig(level=logging.INFO)
    Train()(**_config(args))


def _inference(args):
    from .inference_app import Inference

    Inference()(**_config(args))


def _evaluate(args):
    from ..config import load_yaml
    from .evaluate_app import evaluate

    logging.basicConfig(level=logging.INFO)
    evaluate(load_yaml(args.evaluate_config), load_yaml(args.detect_config),
             max_eval_images=args.max_eval_images, compute_map=not args.no_map,
             coco_map=args.coco_map, device=args.device)


def _convert(args):
    from .convert_app import convert

    logging.basicConfig(level=logging.INFO)
    convert(_config(args))


def _export(args):
    import os

    from ..config import load_yaml
    from .export_app import export_artifact

    logging.basicConfig(level=logging.INFO)
    cfg = load_yaml(args.config)
    cfg["source_config"] = os.path.abspath(args.config)
    export_artifact(cfg, args.out,
                    platforms=tuple(p.strip() for p in args.platforms.split(",") if p.strip()))


COMMANDS = {
    "serve": (_serve_args, _serve, "online batching detection endpoint"),
    "train": (_train_args, _train, "train on a dataset config"),
    "evaluate": (_evaluate_args, _evaluate, "score-threshold sweep: recall, precision, mAP"),
    "inference": (_inference_args, _inference, "batch inference: detect.txt + images"),
    "convert": (_convert_args, _convert, "Darknet .weights -> native .npz checkpoint"),
    "export": (_export_args, _export, "serving artifact: the predictor as a torch.export zip"),
}


def _run(command, argv):
    add_args, run, _ = COMMANDS[command]
    parser = argparse.ArgumentParser(prog=f"python -m yolov3_tpu_torch.apps.cli {command}")
    add_args(parser)
    run(parser.parse_args(argv))


def serve_main(argv=None) -> None:
    _run("serve", argv)


def train_main(argv=None) -> None:
    _run("train", argv)


def evaluate_main(argv=None) -> None:
    _run("evaluate", argv)


def inference_main(argv=None) -> None:
    _run("inference", argv)


def convert_main(argv=None) -> None:
    _run("convert", argv)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.apps.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, (add_args, _, help_text) in COMMANDS.items():
        add_args(sub.add_parser(name, help=help_text))
    args = parser.parse_args(argv)
    COMMANDS[args.command][1](args)


if __name__ == "__main__":
    main()
