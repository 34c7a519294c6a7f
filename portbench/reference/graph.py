"""The model graph, read from the repository's model YAML without the port.

A model file (``config/models/<name>/model.yaml``) lists sub-models; each
names a layer file of ``{type, ...}`` entries over the vocabulary
convolutional, shortcut, route, upsample, maxpool and yolo. This reader
turns them into plain dicts: ``[{"name", "layers", "inputs", "outputs"}]``,
with each layer a dict and a conv's ``filters`` evaluated (the head's
``'3*(2+2+1+nclasses)'``). Layer keys are ``(sub-model name, index)``, the
same names the port gives its parameters, calibration taps and profiler
ranges (``L|<sub-model>|layer<i>|<kind>``).
"""

from __future__ import annotations

import ast
import operator
import os

import yaml

_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
           ast.FloorDiv: operator.floordiv}


def _int_expr(text: str, names: dict) -> int:
    """A small integer expression over ``names`` (``3*(2+2+1+nclasses)``)."""

    def walk(node):
        if isinstance(node, ast.Expression):
            return walk(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name) and node.id in names:
            return int(names[node.id])
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](walk(node.left), walk(node.right))
        raise ValueError(f"unsupported expression {text!r}")

    return walk(ast.parse(text, mode="eval"))


def _layer_file(path: str, model_dir: str) -> str:
    if os.path.exists(path):
        return path
    for candidate in (os.path.join(model_dir, path),
                      os.path.join(model_dir, os.path.basename(path))):
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(path)


def load_graph(model_yaml: str, nclasses: int) -> list:
    """``model_yaml`` → the sub-models in file order (see the module's doc)."""
    with open(model_yaml) as f:
        model = yaml.safe_load(f)
    model_dir = os.path.dirname(os.path.abspath(model_yaml))
    graph = []
    for sub in model["sub_models_configs"]:
        with open(_layer_file(sub["layers_config_file"], model_dir)) as f:
            layers = [dict(layer) for layer in yaml.safe_load(f)["layers_config"]]
        for layer in layers:
            if layer["type"] == "convolutional" and isinstance(layer["filters"], str):
                layer["filters"] = _int_expr(layer["filters"], {"nclasses": nclasses})
        inputs = sub.get("inputs")
        outputs = sub["outputs_layers"]
        graph.append({
            "name": sub["name"], "layers": layers,
            "inputs": None if not inputs else [(e["name"], int(e.get("entry_index", 0)))
                                               for e in inputs["source"]],
            "outputs": [int(i) for i in (outputs if isinstance(outputs, list) else [outputs])]})
    return graph


def conv_shapes(graph) -> dict:
    """{(sm, i): (cout, cin, k)} of every convolution, by walking the graph's
    channel counts from the 3-channel image."""
    produced, shapes = {}, {}
    for sm in graph:
        if sm["inputs"] is None:
            inputs = [3]
        else:
            inputs = [produced[name][idx] for name, idx in sm["inputs"]]
        c, outs = inputs[0], []
        for i, layer in enumerate(sm["layers"]):
            kind = layer["type"]
            if kind == "convolutional":
                shapes[(sm["name"], i)] = (int(layer["filters"]), c, int(layer["size"]))
                c = int(layer["filters"])
            elif kind == "route":
                src = layer["source"]
                sel = [outs[j] for j in src.get("layers", [])] + [inputs[j] for j in
                                                                   src.get("inputs", [])]
                c = sum(sel)
            outs.append(c)
        produced[sm["name"]] = [outs[j] for j in sm["outputs"]]
    return shapes


def head_convs(graph) -> set:
    """The (sm, i) of the conv that feeds each yolo layer (the heads' final
    1×1 convs, which the int8 tiers leave in float)."""
    taps = set()
    for sm in graph:
        for j, layer in enumerate(sm["layers"]):
            if layer["type"] == "yolo":
                i = max(k for k in range(j) if sm["layers"][k]["type"] == "convolutional")
                taps.add((sm["name"], i))
    return taps


def decay_factor(model_yaml: str) -> float:
    """The L2 factor on the kernels the model file states (``decay_factor``)."""
    with open(model_yaml) as f:
        return float(yaml.safe_load(f).get("decay_factor", 0.0))
