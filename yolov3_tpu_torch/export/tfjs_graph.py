"""TFJS graph-model export with neither the tensorflowjs CLI nor TensorFlow.

The reference's browser path (utilities/convert_model_to_tfjs.py:26 of the
reference repository) shells out to ``tensorflowjs_converter`` on a Keras
SavedModel; the produced graph-model (model.json + weight shards) is what
``js/src/inference.js`` loads with ``tf.loadGraphModel``. This module writes
that format directly:

1. ``build_graph_topology`` emits the BN-folded model as the flat node list
   of a TF1 GraphDef of plain ops (Conv2D/BiasAdd/LeakyRelu/MaxPool/ConcatV2/
   AddV2/Pad/Reshape/ResizeNearestNeighbor), every one in the TFJS kernel
   registry, no function library. The nodes are in the JSON form that
   ``json_format.MessageToDict`` gives a GraphDef: each node's ``name``,
   ``op``, ``input`` and ``attr``, with the attrs TensorFlow adds by default
   (Conv2D's ``dilations``, ``explicit_paddings``, ``use_cudnn_on_gpu`` and
   ``data_format`` among them) and each Const's dtype and shape. Names
   follow TensorFlow's unique-name rule, so the nodes are those the JAX
   package's ``build_tf_graph`` builds in TensorFlow, node for node. The Const
   payloads travel beside the nodes, in node order.
2. ``write_graph_model`` serializes the TFJS graph-model format: the Const
   payloads go into 4 MB binary shards with a ``weightsManifest``, and the
   JSON topology keeps only dtype and shape (how the official converter's
   output looks to the TFJS loader, which materializes every Const from the
   manifest by node name). ``quantize`` applies the converter's affine
   uint8/uint16 manifest quantization (``quantize_weight``).
3. ``read_graph_model`` reads model.json and the shards back into a weight
   map, dequantized as ``tf.io.decodeWeights`` does; the port's executor
   (``export/tfjs_runtime.py``) runs the nodes over it in PyTorch.

Its input is JAX-layout numpy params (HWIO kernels), as the JAX package's
``fold_batch_norm`` gives them; the port's ``tools/export_tfjs.py`` builds
them from its own folded tensors. The files equal the JAX package's
TensorFlow-built export (``yolov3_tpu/export/tfjs_graph.py``): model.json as
parsed JSON, apart from ``modelTopology.versions``, which records the
TensorFlow build there and is fixed here (``GRAPH_DEF_PRODUCER``, the
GraphDef version TensorFlow 2.21 writes), and the shards byte for byte
(tests/test_torch_tfjs_export.py).
"""

from __future__ import annotations

import base64
import json
import os
from typing import NamedTuple

import numpy as np

# every op emitted by build_graph_topology, all present in the TFJS op registry
# (tfjs-converter/src/operations/op_list: convolution, arithmetic, basic_math,
# image, matrices, transformation, graph)
TFJS_SUPPORTED_OPS = frozenset({
    "Placeholder", "Const", "Identity", "Pad", "Conv2D", "BiasAdd",
    "LeakyRelu", "MaxPool", "ConcatV2", "Add", "AddV2", "Reshape",
    "ResizeNearestNeighbor",
})

# modelTopology.versions.producer: the GraphDef version of TensorFlow 2.21,
# whose graphs of these ops this module writes
GRAPH_DEF_PRODUCER = 2474

_SHARD_BYTES = 4 * 1024 * 1024  # tensorflowjs default shard size

_NP_TO_TFJS_DTYPE = {
    np.dtype(np.float32): "float32",
    np.dtype(np.int32): "int32",
    np.dtype(np.bool_): "bool",
}
_NP_TO_TF_DTYPE = {
    np.dtype(np.float32): "DT_FLOAT",
    np.dtype(np.int32): "DT_INT32",
    np.dtype(np.bool_): "DT_BOOL",
}
_T = {"type": "DT_FLOAT"}
_NO_LIST = {"list": {}}


class GraphTopology(NamedTuple):
    """A graph-model's nodes (``MessageToDict`` JSON form, Const payloads
    left out) and its Const payloads by node name, in node order."""

    nodes: list
    weights: dict


def _bytes_attr(s: str) -> dict:
    return {"s": base64.b64encode(s.encode()).decode()}


def _ints_attr(values) -> dict:
    return {"list": {"i": [str(int(v)) for v in values]}}


def _shape_json(shape) -> dict:
    return {"dim": [{"size": str(int(d))} for d in shape]} if len(shape) else {}


class _GraphBuilder:
    """Nodes in creation order, named by TensorFlow's ``Graph.unique_name``
    rule, with each tensor's static NHWC shape."""

    def __init__(self):
        self.nodes: list = []
        self.weights: dict = {}
        self.shapes: dict = {}
        self._in_use: dict = {}

    def unique(self, name: str) -> str:
        key = name.lower()
        i = self._in_use.get(key, 0)
        self._in_use[key] = i + 1
        if i == 0:
            return name
        base = key
        while key in self._in_use:
            key = f"{base}_{i}"
            i += 1
        self._in_use[key] = 1
        return f"{name}_{i - 1}"

    def node(self, name, op, inputs, attr, shape):
        entry = {"name": name, "op": op}
        if inputs:
            entry["input"] = list(inputs)
        entry["attr"] = attr
        self.nodes.append(entry)
        self.shapes[name] = tuple(int(d) for d in shape)
        return name

    def const(self, name, value):
        arr = np.array(value, order="C")  # (ascontiguousarray makes a scalar 1-D)
        dtype = _NP_TO_TF_DTYPE[arr.dtype]
        self.weights[name] = arr
        return self.node(name, "Const", (), {
            "value": {"tensor": {"dtype": dtype, "tensorShape": _shape_json(arr.shape)}},
            "dtype": {"type": dtype}}, arr.shape)

    def scoped_op(self, op_name, const_suffix, const_value, op, x, attr, shape):
        """An op whose second input is a Const made in its name scope
        (``Pad/paddings``, ``Reshape/shape``, ``ResizeNearestNeighbor/size``)."""
        name = self.unique(op_name)
        c = self.const(self.unique(f"{name}/{const_suffix}"),
                       np.asarray(const_value, np.int32))
        return self.node(name, op, (x, c), attr, shape)


def build_graph_topology(spec, folded_params, image_size: int):
    """Emit the BN-folded forward as a flat graph of TFJS-registry ops.

    ``folded_params``: the folded params in JAX layout (every conv carries
    {"kernel", "bias"}). Returns ``(graph, input_name, output_names)`` with
    ``graph`` a ``GraphTopology`` and names node names (tensor = name + ":0").
    """
    # imported here: loading a serving artifact imports this package, and no model code
    from ..models.spec import require_activations

    require_activations(spec, ("linear", "leaky"), "the TFJS export")
    # the browser's decode (js/src/decode.js) is YOLOv3's box equation
    for k, scale in enumerate(spec.head_scales()):
        if scale != 1.0:
            raise NotImplementedError(
                f"the TFJS export: head {k} has scale_x_y {scale}, which the browser's decode "
                "cannot compute (only 1)")
    g = _GraphBuilder()
    images = g.node(g.unique("images"), "Placeholder", (), {
        "dtype": dict(_T), "shape": {"shape": _shape_json((1, image_size, image_size, 3))}},
        (1, image_size, image_size, 3))
    produced = {}
    for sm in spec.sub_models:
        if sm.inputs is None:
            inputs_entry = images
        else:
            srcs = [produced[name][entry_index] for name, entry_index in sm.inputs]
            inputs_entry = srcs[0] if len(srcs) == 1 else srcs
        produced[sm.name] = _emit_sub_model(g, sm, folded_params[sm.name], inputs_entry,
                                            spec.nclasses)

    output_names = []
    i = 0
    for sm in spec.output_sub_models:
        for out in produced[sm.name]:
            name = f"head{i}"
            output_names.append(name)
            g.node(g.unique(name), "Identity", (out,), {"T": dict(_T)}, g.shapes[out])
            i += 1
    return GraphTopology(g.nodes, g.weights), images, output_names


def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def _emit_sub_model(g: _GraphBuilder, sm, sm_params, inputs_entry, nclasses: int):
    """The graph twin of models/network.py::_apply_sub_model (folded, inference),
    emitting the nodes TensorFlow emits for the same calls, in its order."""
    x = inputs_entry if not isinstance(inputs_entry, (list, tuple)) else inputs_entry[0]
    layer_outs = []
    for i, layer in enumerate(sm.layers):
        b, h, w, c = g.shapes[x][:4] if len(g.shapes[x]) == 4 else (None,) * 4
        if layer.kind == "convolutional":
            p = sm_params[f"layer{i}"]
            if layer.get("explicit_pad") is not None or layer.get("s2d_phase"):
                raise ValueError(
                    f"{sm.name}/layer{i}: export requires the ORIGINAL spec — "
                    "geometry-rewritten layers (ops/s2d.py) are a TPU-side "
                    "optimization; export the un-rewritten model instead")
            if "kernel_q" in p or "kernel" not in p:
                raise ValueError(
                    f"{sm.name}/layer{i}: export requires raw fp folded params "
                    "(got int8-quantized); quantization is a TPU serving tier, "
                    "re-fold from the fp checkpoint for export")
            kernel = np.asarray(p["kernel"], np.float32)
            bias = np.asarray(p["bias"], np.float32)
            kh, kw, _, cout = kernel.shape
            stride = layer["stride"]
            if stride > 1:
                # Darknet stride-2: ZeroPadding2D ((1,0),(1,0)) + VALID
                # (reference core/parse_model.py:34-35)
                h, w = h + 1, w + 1
                x = g.scoped_op("Pad", "paddings", [[0, 0], [1, 0], [1, 0], [0, 0]], "Pad", x,
                                {"T": dict(_T), "Tpaddings": {"type": "DT_INT32"}},
                                (b, h, w, c))
                padding = "VALID"
            elif layer.get("pad", 1) == 1:
                padding = "SAME"
            else:
                padding = "VALID"
            if padding == "SAME":
                oh, ow = _same_out(h, stride), _same_out(w, stride)
            else:
                oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
            k = g.const(g.unique("Const"), kernel)
            x = g.node(g.unique("Conv2D"), "Conv2D", (x, k), {
                "T": dict(_T), "strides": _ints_attr([1, stride, stride, 1]),
                "use_cudnn_on_gpu": {"b": True}, "padding": _bytes_attr(padding),
                "explicit_paddings": dict(_NO_LIST), "data_format": _bytes_attr("NHWC"),
                "dilations": _ints_attr([1, 1, 1, 1])}, (b, oh, ow, cout))
            bn = g.const(g.unique("Const"), bias)
            x = g.node(g.unique("BiasAdd"), "BiasAdd", (x, bn), {
                "T": dict(_T), "data_format": _bytes_attr("NHWC")}, g.shapes[x])
            if layer.get("activation") == "leaky":
                x = g.node(g.unique("LeakyRelu"), "LeakyRelu", (x,), {
                    "T": dict(_T), "alpha": {"f": 0.1}}, g.shapes[x])
        elif layer.kind == "shortcut":
            src = layer_outs[layer["from"]]
            x = g.node(g.unique("Add"), "AddV2", (src, x), {"T": dict(_T)}, g.shapes[x])
        elif layer.kind == "route":
            source = dict(layer["source"])
            selected = []
            if "layers" in source:
                selected.extend(layer_outs[int(j)] for j in source["layers"])
            if "inputs" in source:
                if isinstance(inputs_entry, (list, tuple)):
                    selected.extend(inputs_entry[int(j)] for j in source["inputs"])
                else:
                    selected.append(inputs_entry)
            if len(selected) == 1:
                x = selected[0]
            else:
                shape = g.shapes[selected[0]]
                channels = sum(g.shapes[s][3] for s in selected)
                name = g.unique("concat")
                axis = g.const(g.unique(f"{name}/axis"), np.asarray(-1, np.int32))
                x = g.node(name, "ConcatV2", (*selected, axis), {
                    "T": dict(_T), "N": {"i": str(len(selected))},
                    "Tidx": {"type": "DT_INT32"}}, (*shape[:3], channels))
        elif layer.kind == "upsample":
            s = layer["stride"]
            # Keras UpSampling2D nearest == ResizeNearestNeighbor with
            # align_corners=False, half_pixel_centers=False (pure repeat)
            x = g.scoped_op("ResizeNearestNeighbor", "size", [h * s, w * s],
                            "ResizeNearestNeighbor", x, {
                                "T": dict(_T), "align_corners": {"b": False},
                                "half_pixel_centers": {"b": False}}, (b, h * s, w * s, c))
        elif layer.kind == "maxpool":
            (sh, sw), (kh, kw) = layer["stride_xy"], layer["size_xy"]
            padding = layer["padding"].upper()
            if padding == "SAME":
                oh, ow = _same_out(h, sh), _same_out(w, sw)
            else:
                oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
            x = g.node(g.unique("MaxPool2d"), "MaxPool", (x,), {
                "T": dict(_T), "ksize": _ints_attr([1, kh, kw, 1]),
                "strides": _ints_attr([1, sh, sw, 1]), "padding": _bytes_attr(padding),
                "explicit_paddings": dict(_NO_LIST), "data_format": _bytes_attr("NHWC")},
                (b, oh, ow, c))
        elif layer.kind == "yolo":
            head = (b, h, w, 3, 5 + nclasses)
            x = g.scoped_op("Reshape", "shape", list(head), "Reshape", x, {
                "T": dict(_T), "Tshape": {"type": "DT_INT32"}}, head)
        else:
            raise ValueError(f"unknown layer kind {layer.kind}")
        layer_outs.append(x)
    return [layer_outs[i] for i in sm.outputs_layers]


def _signature_entry(name, shape):
    return {"name": f"{name}:0", "dtype": "DT_FLOAT",
            "tensorShape": _shape_json(shape)}


def quantize_weight(arr, dtype: str):
    """Affine-quantize a float32 array the tensorflowjs way.

    Returns ``(q, quantization_dict)`` with dequantization
    ``w = q * scale + min`` — the exact affine map
    ``tf.io.decodeWeights`` applies when a manifest entry carries a
    ``quantization`` field (tensorflowjs_converter --quantize_uint8/16).
    """
    qdt = np.dtype(dtype)
    levels = float(np.iinfo(qdt).max)  # 255 / 65535
    lo = float(arr.min()) if arr.size else 0.0
    hi = float(arr.max()) if arr.size else 0.0
    scale = (hi - lo) / levels if hi > lo else 1.0
    q = np.round((arr - lo) / scale).clip(0, levels).astype(qdt)
    return q, {"dtype": dtype, "scale": scale, "min": lo}


def write_graph_model(graph: GraphTopology, out_dir: str, input_name: str,
                      output_names, input_shape, output_shapes,
                      generated_by: str = "yolov3_tpu",
                      quantize: str | None = None):
    """Write TFJS graph-model format: model.json + group1-shard*.bin.

    Const payloads go to the shards (manifest order = node order =
    concatenation order); the JSON topology keeps each Const's dtype/shape
    only — the TFJS loader materializes Const nodes from the weight map by
    node name.

    ``quantize``: None | "uint8" | "uint16" — affine-quantize float32
    weights in the manifest (4×/2× smaller browser download, the official
    converter's --quantize_uint8/16 feature); int32/bool consts stay raw.
    """
    if quantize not in (None, "uint8", "uint16"):
        raise ValueError(f"quantize must be None|uint8|uint16, got {quantize!r}")
    unsupported = sorted({n["op"] for n in graph.nodes} - TFJS_SUPPORTED_OPS)
    if unsupported:
        raise ValueError(f"graph contains ops outside the TFJS registry: {unsupported}")

    weights = []  # (manifest entry, payload array) in manifest order
    for node in graph.nodes:
        if node["op"] == "Const":
            arr = np.array(graph.weights[node["name"]], order="C")
            if arr.dtype not in _NP_TO_TFJS_DTYPE:
                raise ValueError(f"unsupported Const dtype {arr.dtype} at {node['name']}")
            entry = {"name": node["name"], "shape": list(arr.shape),
                     "dtype": _NP_TO_TFJS_DTYPE[arr.dtype]}
            if quantize and arr.dtype == np.float32:
                arr, entry["quantization"] = quantize_weight(arr, quantize)
            weights.append((entry, arr))

    os.makedirs(out_dir, exist_ok=True)
    payload = b"".join(arr.tobytes() for _, arr in weights)
    nshards = max(1, -(-len(payload) // _SHARD_BYTES))
    paths = []
    for s in range(nshards):
        path = f"group1-shard{s + 1}of{nshards}.bin"
        paths.append(path)
        with open(os.path.join(out_dir, path), "wb") as f:
            f.write(payload[s * _SHARD_BYTES:(s + 1) * _SHARD_BYTES])

    model_json = {
        "format": "graph-model",
        "generatedBy": generated_by,
        "convertedBy": "yolov3_tpu pure-python converter",
        "signature": {
            "inputs": {input_name: _signature_entry(input_name, input_shape)},
            "outputs": {name: _signature_entry(name, shape)
                        for name, shape in zip(output_names, output_shapes)},
        },
        "modelTopology": {"node": graph.nodes,
                          "versions": {"producer": GRAPH_DEF_PRODUCER}},
        "weightsManifest": [{
            "paths": paths,
            "weights": [entry for entry, _ in weights],
        }],
    }
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        json.dump(model_json, f)
    return os.path.join(out_dir, "model.json")


def read_graph_model(model_dir: str):
    """Load model.json and its shards → ``(model_json, weight_map)``, the
    weight map holding every Const's payload by node name, dequantized as
    ``tf.io.decodeWeights`` does (``w = q * scale + min`` in float32) — the
    same materialization the TFJS runtime performs."""
    with open(os.path.join(model_dir, "model.json")) as f:
        model_json = json.load(f)

    manifest = model_json["weightsManifest"][0]
    chunks = []
    for p in manifest["paths"]:
        with open(os.path.join(model_dir, p), "rb") as f:
            chunks.append(f.read())
    payload = b"".join(chunks)
    weight_map = {}
    offset = 0
    for w in manifest["weights"]:
        quant = w.get("quantization")
        dtype = np.dtype(quant["dtype"] if quant else w["dtype"])
        count = int(np.prod(w["shape"], dtype=np.int64)) if w["shape"] else 1
        nbytes = count * dtype.itemsize
        arr = np.frombuffer(
            payload[offset:offset + nbytes], dtype=dtype).reshape(w["shape"])
        if quant:  # tf.io.decodeWeights affine dequantization
            arr = (arr.astype(np.float32) * np.float32(quant["scale"])
                   + np.float32(quant["min"])).astype(w["dtype"])
        weight_map[w["name"]] = arr
        offset += nbytes
    if offset != len(payload):
        raise ValueError(f"shard payload size mismatch: {offset} != {len(payload)}")
    return model_json, weight_map
