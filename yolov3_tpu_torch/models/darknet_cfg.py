"""Darknet ``.cfg`` model configs — extension (the reference only reads
its own YAML DSL; Darknet users carry ``yolov3*.cfg`` files).

Framework-neutral copy of ``yolov3_tpu/models/darknet_cfg.py``.

``model_config_file: yolov3.cfg`` now works everywhere a YAML model
config does: the INI-style sections ([convolutional], [shortcut],
[route], [upsample], [maxpool], [yolo]) map 1:1 onto the same
``LayerSpec`` list the YAML DSL produces (one flat sub-model, like the
compact format — compact_spec.py), so the functional interpreter, the
Darknet ``.weights`` importer, checkpoints, transfer learning, and every
serving tier work unchanged. Together with ``convert.py`` this makes
``(yolov3.cfg, yolov3.weights)`` a complete import path.

Layer-reference semantics are Darknet's own and survive verbatim: route
``layers=`` entries and shortcut ``from=`` are relative (negative) or
absolute (≥ 0) layer indices — exactly what the interpreter's
``layer_outs`` list indexing implements (models/network.py:32-52,120).

Head adaptation: when the run's class count differs from the cfg's
``[yolo] classes=`` value, each conv directly preceding a [yolo] whose
``filters`` equals ``len(mask)·(classes+5)`` is rewritten to
``len(mask)·(nclasses+5)`` — the same nclasses-parameterization the YAML
DSL's filter expressions give (reference core/parse_model.py:258-259),
so a stock 80-class cfg trains on any dataset without editing.
"""

from __future__ import annotations

from .spec import ACTIVATIONS, LayerSpec, ModelSpec, SubModelSpec, _attrs, _scale_x_y


def _read_sections(path: str):
    """→ [(section_name, {key: raw_string_value})] in file order."""
    sections = []
    with open(path, "r") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.split("#")[0].split(";")[0].strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                sections.append((line[1:-1].strip().lower(), {}))
            elif "=" in line:
                if not sections:
                    raise ValueError(f"{path}:{lineno}: key before any [section]")
                key, value = line.split("=", 1)
                sections[-1][1][key.strip()] = value.strip()
            else:
                raise ValueError(f"{path}:{lineno}: unparseable line {line!r}")
    return sections


def _int_list(value: str):
    return [int(v.strip()) for v in value.split(",") if v.strip()]


def write_darknet_cfg(spec: ModelSpec, path: str, image_size: int = 416,
                      anchors=None):
    """The inverse: emit a ModelSpec (any of the three config formats) as
    a Darknet ``.cfg``. Sub-models flatten to one global layer list, so
    route/shortcut references must be rewritten from per-sub-model indices
    to global ones; sub-model input edges become [route] sections (a
    Darknet-native construct). Round-trip parity is pinned by
    tests/test_darknet_cfg.py for all three bundled families."""
    lines = [f"[net]", f"width={int(image_size)}", f"height={int(image_size)}",
             "channels=3", ""]
    anchors_str = None
    if anchors is not None:
        import numpy as np

        flat = np.asarray(anchors, np.float32).reshape(-1, 2) * image_size
        anchors_str = ",  ".join(f"{int(round(w))},{int(round(h))}"
                                 for w, h in flat)

    sm_by_name = {sm.name: sm for sm in spec.sub_models}

    def _is_image_route(sm, layer):
        """Route whose only source is the global image input (the edge
        sub-model's leading route) — implicit in Darknet, not emitted."""
        if layer.kind != "route" or sm.inputs is not None:
            return False
        source = dict(layer["source"])
        return list(source) == ["inputs"]

    # assign a global Darknet section index to every emitted layer, in
    # sub-model config order (the interpreter's execution order); skipped
    # image-input routes map to the previous section (identity in Darknet)
    global_idx = {}
    pos = 0
    for sm in spec.sub_models:
        for i, layer in enumerate(sm.layers):
            if _is_image_route(sm, layer):
                global_idx[(sm.name, i)] = pos - 1  # only valid mid-chain
            else:
                global_idx[(sm.name, i)] = pos
                pos += 1

    def tap_global(src_name, entry_index):
        src = sm_by_name[src_name]
        out_local = src.outputs_layers[entry_index]
        if out_local < 0:
            out_local += len(src.layers)
        return global_idx[(src_name, out_local)]

    yolo_count = 0
    n_yolo = sum(1 for sm in spec.sub_models for l in sm.layers
                 if l.kind == "yolo")
    for sm in spec.sub_models:
        for local, layer in enumerate(sm.layers):
            if _is_image_route(sm, layer):
                if local != 0:
                    raise ValueError(
                        f"{sm.name}: image-input route at layer {local} — "
                        f"only a leading one is expressible in a cfg")
                continue
            pos = global_idx[(sm.name, local)]
            if layer.kind == "convolutional":
                lines.append("[convolutional]")
                if layer.get("batch_normalize"):
                    lines.append("batch_normalize=1")
                lines += [f"filters={layer['filters']}",
                          f"size={layer['size']}",
                          f"stride={layer['stride']}",
                          f"pad={layer.get('pad', 1)}",
                          f"activation={layer.get('activation', 'linear')}", ""]
            elif layer.kind == "shortcut":
                frm = layer["from"]
                target_local = frm if frm >= 0 else local + frm
                frm_global = global_idx[(sm.name, target_local)]
                lines += ["[shortcut]", f"from={frm_global - pos}",
                          "activation=linear", ""]
            elif layer.kind == "route":
                source = dict(layer["source"])
                refs = []
                for r in source.get("layers", ()):  # local indices
                    target_local = int(r) if int(r) >= 0 else local + int(r)
                    refs.append(global_idx[(sm.name, target_local)])
                for ei in source.get("inputs", ()):
                    src_name, entry = sm.inputs[int(ei)]
                    refs.append(tap_global(src_name, entry))
                lines += ["[route]",
                          "layers = " + ",".join(str(r) for r in refs), ""]
            elif layer.kind == "upsample":
                lines += ["[upsample]", f"stride={layer['stride']}", ""]
            elif layer.kind == "maxpool":
                lines += ["[maxpool]", f"size={layer['size_xy'][0]}",
                          f"stride={layer['stride_xy'][0]}", ""]
            elif layer.kind == "yolo":
                # mask rows index the anchors= line we emit, which is OUR
                # anchors-file order: row block i pairs with head i
                # (self-consistent; decode pairs anchors_table[i] with
                # output i — ops/decode.py)
                mask_base = yolo_count * 3
                lines.append("[yolo]")
                lines.append(
                    f"mask = {mask_base},{mask_base + 1},{mask_base + 2}")
                if anchors_str:
                    lines.append(f"anchors = {anchors_str}")
                if "scale_x_y" in dict(layer.attrs):
                    lines.append(f"scale_x_y = {layer['scale_x_y']}")
                lines += [f"classes={spec.nclasses}", f"num={3 * n_yolo}", ""]
                yolo_count += 1
            else:
                raise ValueError(f"cannot emit layer kind {layer.kind!r}")

    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def parse_darknet_cfg(path: str, nclasses: int) -> ModelSpec:
    sections = _read_sections(path)
    layer_sections = [(name, conf) for name, conf in sections
                      if name not in ("net", "network")]

    layers: list[LayerSpec] = []
    yolo_indices: list[int] = []
    for idx, (name, conf) in enumerate(layer_sections):
        if name == "convolutional":
            activation = conf.get("activation", "linear")
            if activation not in ACTIVATIONS:
                raise ValueError(
                    f"{path}: [convolutional] #{idx} activation "
                    f"{activation!r} unsupported ({' | '.join(ACTIVATIONS)})")
            layers.append(LayerSpec("convolutional", _attrs({
                "filters": int(conf["filters"]),
                "size": int(conf["size"]),
                "stride": int(conf.get("stride", 1)),
                "pad": int(conf.get("pad", 0)),
                "batch_normalize": bool(int(conf.get("batch_normalize", 0))),
                "activation": activation,
            })))
        elif name == "shortcut":
            layers.append(LayerSpec("shortcut", _attrs({
                "from": int(conf["from"]), "activation": "linear",
            })))
        elif name == "route":
            layers.append(LayerSpec("route", _attrs({
                "source": {"layers": _int_list(conf["layers"])},
            })))
        elif name == "upsample":
            layers.append(LayerSpec("upsample", _attrs({
                "stride": int(conf.get("stride", 2)),
            })))
        elif name == "maxpool":
            size = int(conf.get("size", 2))
            stride = int(conf.get("stride", size))
            layers.append(LayerSpec("maxpool", _attrs({
                "size_xy": [size, size], "stride_xy": [stride, stride],
                "padding": "same",
            })))
        elif name == "yolo":
            cfg_classes = int(conf.get("classes", nclasses))
            mask_len = len(_int_list(conf["mask"])) if "mask" in conf else 3
            if layers and layers[-1].kind == "convolutional":
                prev = dict(layers[-1].attrs)
                if prev["filters"] == mask_len * (cfg_classes + 5):
                    prev["filters"] = mask_len * (int(nclasses) + 5)
                    layers[-1] = LayerSpec("convolutional", _attrs(prev))
                elif cfg_classes != nclasses:
                    raise ValueError(
                        f"{path}: [yolo] #{idx} classes={cfg_classes} != "
                        f"nclasses={nclasses} and the preceding conv's "
                        f"filters ({prev['filters']}) don't match "
                        f"{mask_len}*(classes+5) — edit the cfg")
            yolo_indices.append(len(layers))
            layers.append(LayerSpec("yolo", _attrs(
                {"scale_x_y": _scale_x_y(conf["scale_x_y"])} if "scale_x_y" in conf else {})))
        else:
            raise ValueError(
                f"{path}: unsupported section [{name}] — this parser covers "
                f"the YOLOv3 family (convolutional/shortcut/route/upsample/"
                f"maxpool/yolo)")

    if not yolo_indices:
        raise ValueError(f"{path}: no [yolo] sections — not a YOLO cfg?")

    sub = SubModelSpec(name="model", layers=tuple(layers), inputs=None,
                       outputs_layers=tuple(yolo_indices))
    return ModelSpec(sub_models=(sub,), output_stage="model",
                     decay_factor=0.0, grid_sizes=(), nclasses=int(nclasses))
