"""Functional model interpreter: (spec, params, state, images) → head outputs.

Counterpart of ``yolov3_tpu/models/network.py``. Parameters and BatchNorm
running statistics are plain nested dicts of tensors with the JAX package's
keys, so checkpoints move across unchanged (``io/checkpoint.py``):

    params[sub_model][f"layer{i}"] = {"kernel" (OIHW), ("bias" | "bn": {gamma, beta})}
    state [sub_model][f"layer{i}"] = {"mean", "var"}          (BN layers only)

Activations flow NCHW inside; the public boundary keeps the JAX layout:
``images`` are NHWC and each head output is ``(B, g, g, 3, 5+nc)`` (the
head is permuted to NHWC before the reshape, so channel ``a·(5+nc)+f``
maps exactly as in JAX). A conv applies BN iff its param dict holds a
"bn" entry, which makes ``fold_batch_norm`` a pure params→params transform.
"""

from __future__ import annotations

import torch

from . import layers as L
from .spec import LayerSpec, ModelSpec, SubModelSpec


def _route_sources(layer: LayerSpec, inputs_entry, layer_outs):
    """Reference core/parse_model.py:102-140 route semantics."""
    source = dict(layer["source"])
    selected = []
    if "layers" in source:
        selected.extend(layer_outs[int(i)] for i in source["layers"])
    if "inputs" in source:
        if isinstance(inputs_entry, (list, tuple)):
            selected.extend(inputs_entry[int(i)] for i in source["inputs"])
        else:
            selected.append(inputs_entry)
    if len(selected) == 1:
        return selected[0]
    if len(selected) == 2:
        return torch.cat(selected, dim=1)
    raise ValueError(f"Invalid number of route sources: {len(selected)}")


def _apply_sub_model(sm: SubModelSpec, sm_params, sm_state, inputs_entry,
                     nclasses: int):
    x = inputs_entry if not isinstance(inputs_entry, (list, tuple)) else inputs_entry[0]
    layer_outs = []
    for i, layer in enumerate(sm.layers):
        key = f"layer{i}"
        if layer.kind == "convolutional":
            p = sm_params[key]
            x = L.conv2d(x, p["kernel"], layer["stride"], layer.get("pad", 1),
                         explicit_pad=layer.get("explicit_pad"))
            if "bn" in p:
                x = L.batch_norm(x, p["bn"], sm_state[key])
            elif "bias" in p:
                x = x + p["bias"].to(x.dtype).view(1, -1, 1, 1)
            if layer.get("activation") == "leaky":
                x = L.leaky_relu(x)
        elif layer.kind == "shortcut":
            x = layer_outs[layer["from"]] + x
        elif layer.kind == "route":
            x = _route_sources(layer, inputs_entry, layer_outs)
        elif layer.kind == "upsample":
            x = L.upsample_nearest(x, layer["stride"])
        elif layer.kind == "maxpool":
            x = L.max_pool(x, list(layer["size_xy"]), list(layer["stride_xy"]),
                           layer["padding"])
        elif layer.kind == "yolo":
            # raw logits, no activation (reference parse_model.py:209-211);
            # NHWC before the reshape keeps JAX's channel→(anchor, field) map
            b, c, h, w = x.shape
            x = x.permute(0, 2, 3, 1).reshape(b, h, w, 3, 5 + nclasses)
        else:
            raise ValueError(f"unknown layer kind {layer.kind}")
        layer_outs.append(x)
    return [layer_outs[i] for i in sm.outputs_layers]


def apply_model(spec: ModelSpec, params, state, images):
    """Inference forward. ``images``: (B, H, W, 3) float tensor.

    Returns the list of head outputs ``(B, g, g, 3, 5+nc)`` in the order of
    the sub-models whose name contains ``spec.output_stage`` (13-grid head
    first for yolov3), in ``images.dtype``.
    """
    x = images.permute(0, 3, 1, 2)
    produced = {}
    for sm in spec.sub_models:
        if sm.inputs is None:
            inputs_entry = x
        else:
            srcs = [produced[name][entry_index] for name, entry_index in sm.inputs]
            inputs_entry = srcs[0] if len(srcs) == 1 else srcs
        produced[sm.name] = _apply_sub_model(sm, params[sm.name], state.get(sm.name, {}),
                                             inputs_entry, spec.nclasses)
    outputs = []
    for sm in spec.output_sub_models:
        outputs.extend(produced[sm.name])
    return outputs


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _infer_channels(spec: ModelSpec):
    """Static channel-count inference per layer, for param shapes."""
    produced = {}
    per_layer = {}
    for sm in spec.sub_models:
        if sm.inputs is None:
            inputs_c = 3
        else:
            srcs = [produced[name][entry_index] for name, entry_index in sm.inputs]
            inputs_c = srcs[0] if len(srcs) == 1 else srcs
        c = inputs_c if not isinstance(inputs_c, list) else inputs_c[0]
        outs_c = []
        for i, layer in enumerate(sm.layers):
            if layer.kind == "convolutional":
                per_layer[(sm.name, i)] = (c, layer["filters"])
                c = layer["filters"]
            elif layer.kind == "route":
                source = dict(layer["source"])
                sel = []
                if "layers" in source:
                    sel.extend(outs_c[int(j)] for j in source["layers"])
                if "inputs" in source:
                    if isinstance(inputs_c, list):
                        sel.extend(inputs_c[int(j)] for j in source["inputs"])
                    else:
                        sel.append(inputs_c)
                c = sum(sel) if len(sel) > 1 else sel[0]
            outs_c.append(c)
        produced[sm.name] = [outs_c[i] for i in sm.outputs_layers]
    return per_layer


def init_model(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32):
    """(params, state) with Keras-default initializers: glorot-uniform kernels
    drawn from ``generator`` (a CPU ``torch.Generator``), BN gamma 1 / beta 0,
    running mean 0 / var 1, bias 0. Tensors live on the CPU; move them with
    ``to_device``."""
    per_layer = _infer_channels(spec)
    params, state = {}, {}
    for sm in spec.sub_models:
        sm_params, sm_state = {}, {}
        for i, layer in enumerate(sm.layers):
            if layer.kind != "convolutional":
                continue
            cin, cout = per_layer[(sm.name, i)]
            k = layer["size"]
            entry = {"kernel": L.glorot_uniform(generator, (cout, cin, k, k), dtype)}
            if layer["batch_normalize"]:
                entry["bn"] = {"gamma": torch.ones(cout, dtype=dtype),
                               "beta": torch.zeros(cout, dtype=dtype)}
                sm_state[f"layer{i}"] = {"mean": torch.zeros(cout), "var": torch.ones(cout)}
            else:
                entry["bias"] = torch.zeros(cout, dtype=dtype)
            sm_params[f"layer{i}"] = entry
        params[sm.name] = sm_params
        if sm_state:
            state[sm.name] = sm_state
    return params, state


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


def to_device(tree, device, dtype=None):
    """Move (and optionally cast) every tensor of a params/state tree."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype or tree.dtype)


def fold_batch_norm(params, state, eps: float = L.BN_EPS):
    """Fold BN into conv kernel+bias for inference (pure params transform).

    y = gamma*(conv(x) - mean)/sqrt(var+eps) + beta
      = conv(x, kernel*s) + (beta - mean*s),  s = gamma/sqrt(var+eps)
    """
    folded = {}
    for sm_name, sm_params in params.items():
        sm_folded = {}
        for key, entry in sm_params.items():
            if "bn" in entry:
                bn = entry["bn"]
                st = state[sm_name][key]
                s = bn["gamma"] / torch.sqrt(st["var"] + eps)
                sm_folded[key] = {
                    "kernel": entry["kernel"] * s.view(-1, 1, 1, 1),
                    "bias": bn["beta"] - st["mean"] * s,
                }
            else:
                sm_folded[key] = dict(entry)
        folded[sm_name] = sm_folded
    return folded


def head_grid_sizes(spec: ModelSpec, image_size: int):
    """Grid size of each head output at a given input resolution, from the
    actual graph run on meta tensors (shapes only, no FLOPs)."""
    params = {}
    for (sm_name, i), (cin, cout) in _infer_channels(spec).items():
        k = _spec_layer(spec, sm_name, i)["size"]
        params.setdefault(sm_name, {})[f"layer{i}"] = {
            "kernel": torch.empty((cout, cin, k, k), device="meta"),
            "bias": torch.empty((cout,), device="meta")}
    for sm in spec.sub_models:
        params.setdefault(sm.name, {})
    images = torch.empty((1, image_size, image_size, 3), device="meta")
    return tuple(o.shape[1] for o in apply_model(spec, params, {}, images))


def _spec_layer(spec: ModelSpec, sm_name: str, i: int) -> LayerSpec:
    return next(sm for sm in spec.sub_models if sm.name == sm_name).layers[i]


def param_count(params) -> int:
    total = 0
    for sm_params in params.values():
        for entry in sm_params.values():
            total += entry["kernel"].numel()
            total += entry["bias"].numel() if "bias" in entry else 0
            if "bn" in entry:
                total += sum(v.numel() for v in entry["bn"].values())
    return total
