"""Browser (TFJS) graph-model export of a port checkpoint.

Counterpart of the TFJS graph-model leg of the JAX package's
``utilities/convert_model_to_tfjs.py`` (the jax2tf SavedModel leg has no
counterpart here). The BN-folded model is re-emitted as a flat TF GraphDef of
TFJS-registry ops and written as model.json + 4 MB weight shards
(``export/tfjs_graph.py``), which ``js/src/inference.js`` loads with
``tf.loadGraphModel``; no tensorflowjs CLI is needed, but TensorFlow is. The
reference's L2→L1L2 regularizer-name patch is applied to model.json. It
touches no device: the weights are folded on the CPU.

Usage:
  python -m yolov3_tpu_torch.tools.export_tfjs \\
      --model_config_file config/models/yolov3_tiny/model.yaml \\
      --weights_path checkpoints/output/yolov3_train_tiny.tf \\
      --classes_name_file datasets/shapes_toy/class.names \\
      --image_size 416 --tfjs_out_dir <dir> [--quantize uint8]
"""

from __future__ import annotations

import argparse
import os

import torch


def load_folded_model(model_config_file, weights_path, classes_name_file):
    """(spec, folded params): parse, load weights, fold BN. The folded
    params are JAX-layout numpy trees (HWIO kernels), what
    ``export/tfjs_graph.py`` takes."""
    from ..config import count_file_lines
    from ..io.resolve import load_weights
    from ..models import fold_batch_norm, init_model, parse_model_config
    from ..models.convert import params_to_jax

    nclasses = count_file_lines(classes_name_file)
    spec = parse_model_config(model_config_file, nclasses)
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    params, state = load_weights(spec, params, state, weights_path)
    folded, _ = params_to_jax(fold_batch_norm(params, state), {})
    return spec, folded


def export_tfjs_graph_model(model_config_file, weights_path, classes_name_file,
                            image_size, out_dir, quantize=None):
    """Pure-Python TFJS graph-model export (no tensorflowjs CLI).

    ``quantize``: None | "uint8" | "uint16" — affine manifest quantization
    (the official converter's --quantize_uint8/16; 4×/2× smaller download).
    """
    from ..export import build_tf_graph, write_graph_model
    from ..models.network import head_grid_sizes

    spec, folded = load_folded_model(model_config_file, weights_path, classes_name_file)

    graph_def, input_name, output_names = build_tf_graph(spec, folded, image_size)
    grids = head_grid_sizes(spec, image_size)
    output_shapes = [(1, g, g, 3, 5 + spec.nclasses) for g in grids]
    path = write_graph_model(graph_def, out_dir, input_name, output_names,
                             (1, image_size, image_size, 3), output_shapes,
                             quantize=quantize)
    patch_model_json(out_dir)
    print(f"TFJS graph model written to {path}"
          + (f" (weights {quantize}-quantized)" if quantize else ""))
    return path


def patch_model_json(tfjs_dir):
    """Reference patch: '"L2"' → '"L1L2"' regularizer class name."""
    path = os.path.join(tfjs_dir, "model.json")
    with open(path) as f:
        content = f.read()
    with open(path, "w") as f:
        f.write(content.replace('"L2"', '"L1L2"'))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.export_tfjs")
    parser.add_argument("--model_config_file", required=True)
    parser.add_argument("--weights_path", required=True)
    parser.add_argument("--classes_name_file", required=True)
    parser.add_argument("--image_size", type=int, default=416)
    parser.add_argument("--tfjs_out_dir", required=True)
    parser.add_argument("--quantize", choices=["uint8", "uint16"], default=None,
                        help="affine-quantize manifest weights (smaller download)")
    args = parser.parse_args(argv)
    export_tfjs_graph_model(args.model_config_file, args.weights_path,
                            args.classes_name_file, args.image_size,
                            args.tfjs_out_dir, quantize=args.quantize)


if __name__ == "__main__":
    main()
