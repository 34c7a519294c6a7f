"""One-shot legacy-checkpoint converter: Keras save_weights (TF format) →
native .npz weights.

Counterpart of the JAX package's ``tools/convert_tf_checkpoint.py``. The port
reads legacy Keras TF-format checkpoints transparently
(``yolov3_tpu_torch/io/resolve.py``), but that path needs tensorflow
installed. This tool converts once, after which TF is not needed at all.
Mapping = the same Keras object-graph walk the transparent reader uses
(``io/checkpoint.py::_weighted_layer_paths``; reference save format:
train.py:76-78, load: inference.py:102). It touches no device.

Usage:
  python -m yolov3_tpu_torch.tools.convert_tf_checkpoint \\
      --model-config config/models/yolov3/model.yaml \\
      --classes-name-file datasets/coco2012/coco.names \\
      --input checkpoints/keras_coco_yolov3.tf \\
      --output checkpoints/keras_coco_yolov3.tf.npz

(--nclasses N may replace --classes-name-file.)
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.convert_tf_checkpoint",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model-config", required=True,
                    help="model DSL yaml matching the checkpointed architecture")
    ap.add_argument("--classes-name-file", help=".names file (sets nclasses)")
    ap.add_argument("--nclasses", type=int, help="number of classes (alternative)")
    ap.add_argument("--input", required=True,
                    help="TF checkpoint prefix (the path passed to save_weights, "
                         "i.e. without .index/.data suffixes)")
    ap.add_argument("--output", help="output .npz path "
                    "(default: <input>.npz, the transparent-load location)")
    args = ap.parse_args(argv)

    if (args.classes_name_file is None) == (args.nclasses is None):
        ap.error("exactly one of --classes-name-file / --nclasses is required")

    from ..config import count_file_lines
    from ..io.checkpoint import load_tf_keras_checkpoint
    from ..io.resolve import native_path, save_weights
    from ..models import init_model, parse_model_config

    nclasses = args.nclasses or count_file_lines(args.classes_name_file)
    spec = parse_model_config(args.model_config, nclasses)
    params, state = init_model(spec, torch.Generator().manual_seed(0))

    params, state, loaded = load_tf_keras_checkpoint(spec, params, state, args.input)
    if loaded == 0:
        raise SystemExit(f"error: {args.input} matched no variables of "
                         f"{args.model_config} (wrong architecture or path?)")

    out = args.output or native_path(args.input)
    save_weights(spec, params, state, out)
    print(f"converted {args.input} -> {native_path(out)} ({loaded} variables)")


if __name__ == "__main__":
    main()
