"""Compact single-file model format (reference core/newparse.py).

Framework-neutral copy of ``yolov3_tpu/models/compact_spec.py``.

Parses the YOLOv5-style format of config/models/yolov3_tiny/yolov3_tiny.yaml:
sections (backbone / head / …) of rows ``[from, number, module, args]``
numbered globally across sections; modules Conv, Maxpool, Upsample, Concat,
Shortcut, Reshape, Output. Arg expressions may reference ``nc`` (classes)
and ``na`` (anchors per scale), e.g. ``na*(nc+5)`` — evaluated with the
restricted AST walker.

Output is the same ``ModelSpec`` the multi-file DSL produces (one sub-model
holding the flat layer list), so the functional interpreter, Darknet
importer, checkpoints and transfer utilities all work unchanged.
"""

from __future__ import annotations

from ..config import load_yaml, safe_eval_expr
from .spec import ACTIVATIONS, LayerSpec, ModelSpec, SubModelSpec, _attrs

NUM_ANCHORS = 3


def _ev(value, variables):
    if isinstance(value, str):
        return safe_eval_expr(value, variables)
    if isinstance(value, list):
        return [_ev(v, variables) for v in value]
    return value


def parse_compact_model_config(path: str, nclasses: int) -> ModelSpec:
    config = load_yaml(path)
    variables = {"nc": int(nclasses), "na": NUM_ANCHORS}

    rows = []
    for section, section_rows in config.items():
        if isinstance(section_rows, list):
            rows.extend(section_rows)

    layers: list[LayerSpec] = []
    row_to_layer: list[int] = []  # global row index -> index into `layers`
    outputs_layers = None
    grid_sizes = []

    def resolve(ref: int, row_idx: int) -> int:
        """Row reference (absolute ≥0 or relative <0) → my layer index."""
        target_row = ref if ref >= 0 else row_idx + ref
        if not 0 <= target_row < len(row_to_layer):
            raise ValueError(f"row {row_idx}: reference {ref} out of range")
        return row_to_layer[target_row]

    for row_idx, (frm, number, module, args) in enumerate(rows):
        args = _ev(list(args), variables)
        for rep in range(int(number)):
            # non-chain input (anything but plain -1) becomes an explicit route
            if module == "Output":
                refs = frm if isinstance(frm, list) else [frm]
                outputs_layers = tuple(resolve(int(r), row_idx) for r in refs)
                row_to_layer.append(len(layers) - 1)
                break
            if module == "Concat":
                refs = [resolve(int(r), row_idx) for r in frm]
                layers.append(LayerSpec("route", _attrs({"source": {"layers": refs}})))
            elif module == "Shortcut":
                # add referenced row into the chain (absolute layer index —
                # the interpreter indexes the layer list directly)
                ref = frm[1] if isinstance(frm, list) else (int(args[0]) if args else -3)
                layers.append(LayerSpec("shortcut", _attrs({
                    "from": resolve(int(ref), row_idx), "activation": "linear",
                })))
            else:
                if not isinstance(frm, list) and int(frm) != -1 and rep == 0:
                    layers.append(LayerSpec("route", _attrs({"source": {"layers": [resolve(int(frm), row_idx)]}})))
                if module == "Conv":
                    filters, k, s = int(args[0]), int(args[1]), int(args[2])
                    pad = int(args[3]) if len(args) > 3 else 1
                    bn = bool(args[4]) if len(args) > 4 else True
                    # a truthy flag is LeakyReLU; a name is that activation
                    act = args[5] if len(args) > 5 else False
                    act = act if act in ACTIVATIONS else "leaky" if act else "linear"
                    layers.append(LayerSpec("convolutional", _attrs({
                        "filters": filters, "size": k, "stride": s, "pad": pad,
                        "batch_normalize": bn, "activation": act,
                    })))
                elif module == "Maxpool":
                    size_xy, stride_xy = args[0], args[1]
                    layers.append(LayerSpec("maxpool", _attrs({
                        "size_xy": [int(v) for v in size_xy],
                        "stride_xy": [int(v) for v in stride_xy],
                        "padding": "same",
                    })))
                elif module == "Upsample":
                    layers.append(LayerSpec("upsample", _attrs({"stride": int(args[0])})))
                elif module == "Reshape":
                    grid_sizes.append(int(args[0]))
                    layers.append(LayerSpec("yolo", _attrs({"grid_size": int(args[0])})))
                else:
                    raise ValueError(f"unknown compact module {module!r}")
        else:
            row_to_layer.append(len(layers) - 1)
            continue
        break  # Output row terminates

    if outputs_layers is None:
        outputs_layers = (len(layers) - 1,)

    sub = SubModelSpec(name="model", layers=tuple(layers), inputs=None,
                       outputs_layers=outputs_layers)
    return ModelSpec(sub_models=(sub,), output_stage="model",
                     decay_factor=0.0, grid_sizes=tuple(grid_sizes),
                     nclasses=int(nclasses))
