"""Pure-Python TFJS graph-model export — no tensorflowjs CLI required.

The reference's browser path (utilities/convert_model_to_tfjs.py:26 of the
reference repository) shells out to ``tensorflowjs_converter`` on a Keras
SavedModel; the produced graph-model (model.json + weight shards) is what
``js/src/inference.js`` loads with ``tf.loadGraphModel``. This module writes
that format natively:

1. ``build_tf_graph`` re-emits the BN-folded model as a FLAT TF1 GraphDef
   of plain ops (Conv2D/BiasAdd/LeakyRelu/MaxPool/ConcatV2/AddV2/Pad/
   Reshape/ResizeNearestNeighbor) — every op in the TFJS kernel registry,
   no function library, no XlaCallModule. It mirrors the functional
   interpreter (models/network.py::_apply_sub_model) exactly, so outputs
   match the forward at fp32 tolerance (pinned by
   tests/test_torch_tfjs_export.py).
2. ``write_graph_model`` serializes TFJS graph-model format: Const tensor
   payloads are extracted into 4 MB binary shards with a
   ``weightsManifest``, and the JSON topology keeps only dtype/shape
   (exactly how the official converter's output looks to the TFJS loader,
   which materializes every Const from the manifest by node name).
3. ``read_graph_model`` reconstitutes the GraphDef with the shard payloads
   re-injected — used by tests (and debuggers) to run the exported
   artifact in TF and pin it against the forward.

Its input is JAX-layout numpy params (HWIO kernels), as the JAX package's
``fold_batch_norm`` gives them; the port's ``tools/export_tfjs.py`` builds
them from its own folded tensors. TensorFlow is imported only inside the
functions that need it.

Framework-neutral copy of ``yolov3_tpu/export/tfjs_graph.py`` (the port imports nothing
of the JAX package). tests/test_torch_tfjs_export.py pins its code, everything
after this docstring, to its original.
"""

from __future__ import annotations

import json
import os

import numpy as np

# every op emitted by build_tf_graph, all present in the TFJS op registry
# (tfjs-converter/src/operations/op_list: convolution, arithmetic, basic_math,
# image, matrices, transformation, graph)
TFJS_SUPPORTED_OPS = frozenset({
    "Placeholder", "Const", "Identity", "Pad", "Conv2D", "BiasAdd",
    "LeakyRelu", "MaxPool", "ConcatV2", "Add", "AddV2", "Reshape",
    "ResizeNearestNeighbor",
})

_SHARD_BYTES = 4 * 1024 * 1024  # tensorflowjs default shard size

_NP_TO_TFJS_DTYPE = {
    np.dtype(np.float32): "float32",
    np.dtype(np.int32): "int32",
    np.dtype(np.bool_): "bool",
}


def build_tf_graph(spec, folded_params, image_size: int):
    """Emit the BN-folded forward as a flat TF1 GraphDef.

    ``folded_params``: output of ``models.network.fold_batch_norm`` (every
    conv carries {"kernel", "bias"}). Returns
    ``(graph_def, input_name, output_names)`` where names are node names
    (tensor = name + ":0").
    """
    import tensorflow as tf

    v1 = tf.compat.v1
    graph = tf.Graph()
    with graph.as_default():
        images = v1.placeholder(tf.float32, (1, image_size, image_size, 3),
                                name="images")
        produced = {}
        for sm in spec.sub_models:
            if sm.inputs is None:
                inputs_entry = images
            else:
                srcs = [produced[name][entry_index] for name, entry_index in sm.inputs]
                inputs_entry = srcs[0] if len(srcs) == 1 else srcs
            produced[sm.name] = _emit_sub_model(
                tf, sm, folded_params[sm.name], inputs_entry, spec.nclasses)

        output_names = []
        i = 0
        for sm in spec.output_sub_models:
            for out in produced[sm.name]:
                output_names.append(f"head{i}")
                tf.identity(out, name=f"head{i}")
                i += 1
    return graph.as_graph_def(), "images", output_names


def _emit_sub_model(tf, sm, sm_params, inputs_entry, nclasses: int):
    """TF-ops twin of models/network.py::_apply_sub_model (folded, inference)."""
    x = inputs_entry if not isinstance(inputs_entry, (list, tuple)) else inputs_entry[0]
    layer_outs = []
    for i, layer in enumerate(sm.layers):
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
            stride = layer["stride"]
            if stride > 1:
                # Darknet stride-2: ZeroPadding2D ((1,0),(1,0)) + VALID
                # (reference core/parse_model.py:34-35)
                x = tf.pad(x, [[0, 0], [1, 0], [1, 0], [0, 0]])
                padding = "VALID"
            elif layer.get("pad", 1) == 1:
                padding = "SAME"
            else:
                padding = "VALID"
            x = tf.nn.conv2d(x, tf.constant(kernel),
                             strides=[1, stride, stride, 1], padding=padding)
            x = tf.nn.bias_add(x, tf.constant(bias))
            if layer.get("activation") == "leaky":
                x = tf.nn.leaky_relu(x, alpha=0.1)
        elif layer.kind == "shortcut":
            x = tf.add(layer_outs[layer["from"]], x)
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
            x = selected[0] if len(selected) == 1 else tf.concat(selected, axis=-1)
        elif layer.kind == "upsample":
            s = layer["stride"]
            h, w = int(x.shape[1]), int(x.shape[2])
            # Keras UpSampling2D nearest == ResizeNearestNeighbor with
            # align_corners=False, half_pixel_centers=False (pure repeat)
            x = tf.compat.v1.image.resize_nearest_neighbor(x, [h * s, w * s])
        elif layer.kind == "maxpool":
            (sh, sw), (kh, kw) = layer["stride_xy"], layer["size_xy"]
            x = tf.nn.max_pool2d(x, ksize=[1, kh, kw, 1], strides=[1, sh, sw, 1],
                                 padding=layer["padding"].upper())
        elif layer.kind == "yolo":
            b, h, w, c = (int(d) for d in x.shape)
            x = tf.reshape(x, [b, h, w, 3, 5 + nclasses])
        else:
            raise ValueError(f"unknown layer kind {layer.kind}")
        layer_outs.append(x)
    return [layer_outs[i] for i in sm.outputs_layers]


def _tensor_shape_json(shape):
    return {"dim": [{"size": str(int(d))} for d in shape]}


def _signature_entry(name, shape):
    return {"name": f"{name}:0", "dtype": "DT_FLOAT",
            "tensorShape": _tensor_shape_json(shape)}


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


def write_graph_model(graph_def, out_dir: str, input_name: str,
                      output_names, input_shape, output_shapes,
                      generated_by: str = "yolov3_tpu",
                      quantize: str | None = None):
    """Write TFJS graph-model format: model.json + group1-shard*.bin.

    Const payloads go to the shards (manifest order = concatenation order);
    the JSON topology keeps each Const's dtype/shape only — the TFJS loader
    materializes Const nodes from the weight map by node name.

    ``quantize``: None | "uint8" | "uint16" — affine-quantize float32
    weights in the manifest (4×/2× smaller browser download, the official
    converter's --quantize_uint8/16 feature); int32/bool consts stay raw.
    """
    from google.protobuf import json_format
    from tensorflow.python.framework import tensor_util

    if quantize not in (None, "uint8", "uint16"):
        raise ValueError(f"quantize must be None|uint8|uint16, got {quantize!r}")
    unsupported = sorted({n.op for n in graph_def.node} - TFJS_SUPPORTED_OPS)
    if unsupported:
        raise ValueError(f"graph contains ops outside the TFJS registry: {unsupported}")

    weights = []  # (manifest entry, payload array) in manifest order
    for node in graph_def.node:
        if node.op == "Const":
            tensor = node.attr["value"].tensor
            arr = tensor_util.MakeNdarray(tensor)
            # MakeNdarray can return (1,) for scalar protos carried in the
            # *_val fields — force the proto's declared shape so the
            # manifest, the topology and the re-injected Const all agree
            arr = np.ascontiguousarray(arr).reshape(
                [d.size for d in tensor.tensor_shape.dim])
            if arr.dtype not in _NP_TO_TFJS_DTYPE:
                # int64 would need an attr rewrite pass (TFJS weights are
                # 32-bit); build_tf_graph only emits int32 shape/size consts
                # so hitting this means a new op slipped in — fail loudly
                raise ValueError(f"unsupported Const dtype {arr.dtype} at {node.name}")
            entry = {"name": node.name, "shape": list(arr.shape),
                     "dtype": _NP_TO_TFJS_DTYPE[arr.dtype]}
            if quantize and arr.dtype == np.float32:
                arr, entry["quantization"] = quantize_weight(arr, quantize)
            weights.append((entry, arr))

    topology = json_format.MessageToDict(graph_def)
    for node in topology.get("node", []):
        if node.get("op") == "Const":
            tensor = node["attr"]["value"]["tensor"]
            for payload_key in ("tensorContent", "floatVal", "intVal", "int64Val",
                               "boolVal", "doubleVal", "halfVal"):
                tensor.pop(payload_key, None)

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
        "modelTopology": topology,
        "weightsManifest": [{
            "paths": paths,
            "weights": [entry for entry, _ in weights],
        }],
    }
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        json.dump(model_json, f)
    return os.path.join(out_dir, "model.json")


def read_graph_model(model_dir: str):
    """Load model.json + shards back into a runnable GraphDef.

    Returns ``(graph_def, signature)`` with every Const's payload
    re-injected — the same materialization the TFJS runtime performs.
    """
    import tensorflow as tf
    from google.protobuf import json_format
    from tensorflow.python.framework import tensor_util

    with open(os.path.join(model_dir, "model.json")) as f:
        model_json = json.load(f)

    manifest = model_json["weightsManifest"][0]
    payload = b"".join(
        open(os.path.join(model_dir, p), "rb").read() for p in manifest["paths"])
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

    graph_def = json_format.ParseDict(model_json["modelTopology"], tf.compat.v1.GraphDef())
    for node in graph_def.node:
        if node.op == "Const":
            arr = weight_map[node.name]
            node.attr["value"].tensor.CopyFrom(
                tensor_util.make_tensor_proto(arr, shape=arr.shape))
    return graph_def, model_json["signature"]


def run_graph_model(model_dir: str, images):
    """Execute an exported graph-model in TF (test/debug harness)."""
    import tensorflow as tf

    graph_def, signature = read_graph_model(model_dir)
    (input_name,) = signature["inputs"].keys()
    output_tensors = [v["name"] for v in signature["outputs"].values()]
    graph = tf.Graph()
    with graph.as_default():
        tf.compat.v1.import_graph_def(graph_def, name="")
        with tf.compat.v1.Session(graph=graph) as sess:
            outs = sess.run(output_tensors, {f"{input_name}:0": np.asarray(images)})
    # grid order can be arbitrary in signature dict order — sort 13-grid
    # first like the js port (js/src/inference.js:46)
    outs.sort(key=lambda o: o.shape[1])
    return outs
