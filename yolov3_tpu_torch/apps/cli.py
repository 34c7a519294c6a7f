"""Command line of the port: ``python -m yolov3_tpu_torch.apps.cli serve --config …``.

``serve_main`` takes the same arguments without the subcommand. The
config file is the JAX package's ``serve_config.yaml`` schema; ``--device
cpu`` runs the plain PyTorch path on the CPU instead of the card.
"""

from __future__ import annotations

import argparse
import logging


def _serve_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config", type=str, default="config/serve_config.yaml",
                        help="yaml config file")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")


def _serve(args):
    from ..config import load_yaml
    from .serve_app import Serve

    logging.basicConfig(level=logging.INFO)
    cfg = load_yaml(args.config)
    if args.device is not None:
        cfg["device"] = args.device
    Serve()(**cfg)


def serve_main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.apps.cli serve")
    _serve_args(parser)
    _serve(parser.parse_args(argv))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.apps.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    _serve_args(sub.add_parser("serve", help="online batching detection endpoint"))
    args = parser.parse_args(argv)
    if args.command == "serve":
        _serve(args)


if __name__ == "__main__":
    main()
