"""Model DSL → static specification.

Parses the reference's two-tier YAML model format (reference
core/parse_model.py and config/models/**): a ``model.yaml`` lists sub-models
(backbone / necks / heads) with their layer-config files and graph wiring
(``inputs.source`` name + ``entry_index``, ``outputs_layers``); each layer
file holds a ``layers_config`` list over the vocabulary
{convolutional, shortcut, route, upsample, maxpool, yolo}.

The spec is a plain static (hashable-enough) Python structure. It contains
no arrays and no framework objects — the functional interpreter in
``network.py`` turns (spec, params, state, images) into outputs.

Framework-neutral copy of ``yolov3_tpu/models/spec.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..config import load_yaml, safe_eval_expr

# A convolution's activation: ``leaky`` is LeakyReLU(0.1), ``mish`` is
# x·tanh(softplus(x)) (YOLOv4's CSPDarknet53), ``linear`` none.
ACTIVATIONS = ("linear", "leaky", "mish")


@dataclass(frozen=True)
class LayerSpec:
    """One DSL layer. ``kind`` ∈ {convolutional, shortcut, route, upsample,
    maxpool, yolo}; ``attrs`` holds the kind-specific static attributes."""

    kind: str
    attrs: tuple  # sorted tuple of (key, value) pairs — hashable

    def get(self, key, default=None):
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    def __getitem__(self, key):
        v = self.get(key, _MISSING)
        if v is _MISSING:
            raise KeyError(key)
        return v


_MISSING = object()


def _attrs(d: dict) -> tuple:
    def freeze(v):
        if isinstance(v, list):
            return tuple(freeze(x) for x in v)
        if isinstance(v, dict):
            return tuple(sorted((k, freeze(x)) for k, x in v.items()))
        return v

    return tuple(sorted((k, freeze(v)) for k, v in d.items()))


@dataclass(frozen=True)
class SubModelSpec:
    name: str
    layers: tuple  # tuple[LayerSpec]
    # None for the edge (leftmost) sub-model fed by the global image input;
    # otherwise tuple of (source_sub_model_name, entry_index).
    inputs: tuple | None
    outputs_layers: tuple  # indices (may be negative) into the layer list
    # legacy single-file format may give an input shape string instead
    input_shape: tuple | None = None


@dataclass(frozen=True)
class ModelSpec:
    sub_models: tuple  # tuple[SubModelSpec]
    output_stage: str = "head"
    decay_factor: float = 0.0
    grid_sizes: tuple = ()
    nclasses: int = 0
    # {activation: convolutions} over ``ACTIVATIONS``, counted once when the
    # spec is built: a forward runs this many tails of each, and what cannot
    # compute an activation checks it here (``require_activations``)
    activation_counts: dict = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        acts = [layer.get("activation", "linear") for sm in self.sub_models
                for layer in sm.layers if layer.kind == "convolutional"]
        object.__setattr__(self, "activation_counts", {a: acts.count(a) for a in ACTIVATIONS})

    def head_scales(self) -> tuple:
        """Each head output's ``scale_x_y`` (YOLOv4's grid-sensitivity
        factor of the box centre, ``ops/decode.py``), in head order; 1.0
        where the yolo layer states none."""
        return tuple(float(sm.layers[i].get("scale_x_y", 1.0))
                     for sm in self.output_sub_models for i in sm.outputs_layers)

    @property
    def output_sub_models(self) -> tuple:
        """Sub-models whose name contains output_stage, in config order
        (reference core/parse_model.py:310-311)."""
        return tuple(sm for sm in self.sub_models if self.output_stage in sm.name)

    def with_output_stage(self, output_stage: str) -> "ModelSpec":
        """Truncated view used for transfer learning (backbone/neck-only)."""
        return ModelSpec(
            sub_models=self.sub_models,
            output_stage=output_stage,
            decay_factor=self.decay_factor,
            grid_sizes=self.grid_sizes,
            nclasses=self.nclasses,
        )


def _parse_layer(layer_conf: dict, nclasses: int) -> LayerSpec:
    kind = layer_conf["type"]
    conf = dict(layer_conf)
    conf.pop("type")
    if kind == "convolutional":
        filters = conf["filters"]
        if isinstance(filters, str):
            # e.g. '3*(2+2+1+nclasses)' — reference core/parse_model.py:258-259
            filters = int(safe_eval_expr(filters, {"nclasses": nclasses}))
        conf["filters"] = int(filters)
        conf["size"] = int(conf["size"])
        conf["stride"] = int(conf["stride"])
        # presence with no value (YAML `batch_normalize:`) means enabled —
        # the reference configs write `batch_normalize: 1`; an explicit
        # 0/false must be honored, not overridden by key presence
        bn_value = layer_conf.get("batch_normalize")
        conf["batch_normalize"] = (
            True if ("batch_normalize" in layer_conf and bn_value is None)
            else bool(bn_value)
        )
        activation = conf.get("activation", "linear")
        if activation not in ACTIVATIONS:
            raise ValueError(f"Invalid activation: {activation}")
    elif kind == "shortcut":
        if conf.get("activation", "linear") != "linear":
            raise ValueError(f"Invalid activation: {conf.get('activation')}")
        conf["from"] = int(conf["from"])
    elif kind == "upsample":
        conf["stride"] = int(conf["stride"])
    elif kind == "maxpool":
        conf["size_xy"] = [int(v) for v in conf["size_xy"]]
        conf["stride_xy"] = [int(v) for v in conf["stride_xy"]]
    elif kind == "route":
        pass  # source dict frozen as-is
    elif kind == "yolo":
        # grid_size in the DSL is informational; we derive from shapes
        if "scale_x_y" in conf:
            conf["scale_x_y"] = _scale_x_y(conf["scale_x_y"])
    else:
        raise ValueError(f"{kind} not recognized as layer type")
    return LayerSpec(kind=kind, attrs=_attrs(conf))


def _scale_x_y(value) -> float:
    scale = float(value)
    if not scale > 0.0:
        raise ValueError(f"Invalid scale_x_y: {value}")
    return scale


def require_activations(spec: ModelSpec, allowed: tuple, what: str):
    """Raise ``NotImplementedError`` naming the first convolution whose
    activation is not in ``allowed``: ``what`` (a tier, the train step, an
    export) cannot compute it, and must not run it as something else. Reads
    the spec's counts first, so that a model it can run costs no walk."""
    if all(n == 0 for a, n in spec.activation_counts.items() if a not in allowed):
        return
    for sm in spec.sub_models:
        for i, layer in enumerate(sm.layers):
            activation = layer.get("activation", "linear")
            if layer.kind == "convolutional" and activation not in allowed:
                raise NotImplementedError(
                    f"{what}: layer {sm.name}/layer{i} has activation {activation!r}, which "
                    f"it cannot compute (only {' | '.join(allowed)})")


def _parse_sub_model(sub_conf: dict, nclasses: int, config_dir: str) -> SubModelSpec:
    if "layers_config_file" in sub_conf:
        path = sub_conf["layers_config_file"]
        if not os.path.isabs(path) and not os.path.exists(path):
            # allow paths relative to the model.yaml location as a fallback:
            # first the path as written (keeps subdirectories), then the
            # bare basename (reference configs use repo-rooted paths)
            for candidate in (os.path.join(config_dir, path),
                              os.path.join(config_dir, os.path.basename(path))):
                if os.path.exists(candidate):
                    path = candidate
                    break
        layers_conf = load_yaml(path)["layers_config"]
    else:
        layers_conf = sub_conf["layers_config"]

    layers = tuple(_parse_layer(lc, nclasses) for lc in layers_conf)

    inputs_config = sub_conf.get("inputs")
    inputs = None
    input_shape = None
    if inputs_config:
        if "shape" in inputs_config:
            shape = inputs_config["shape"]
            input_shape = tuple(safe_eval_expr(shape)) if isinstance(shape, str) else tuple(shape)
        else:
            inputs = tuple(
                (entry["name"], entry.get("entry_index", 0))
                for entry in inputs_config["source"]
            )

    outputs_layers = sub_conf["outputs_layers"]
    if not isinstance(outputs_layers, list):
        outputs_layers = [outputs_layers]

    return SubModelSpec(
        name=sub_conf["name"],
        layers=layers,
        inputs=inputs,
        outputs_layers=tuple(int(i) for i in outputs_layers),
        input_shape=input_shape,
    )


def parse_model_config(model_config_file: str, nclasses: int) -> ModelSpec:
    """Load a model config into a ModelSpec.

    Accepts three formats: the two-tier model.yaml (+ per-sub-model layer
    files), the compact single-file [from, number, module, args] format
    (reference core/newparse.py) — dispatched on the presence of
    ``sub_models_configs`` — and raw Darknet ``.cfg`` files (extension;
    models/darknet_cfg.py), dispatched on the file extension."""
    if str(model_config_file).endswith(".cfg"):
        from .darknet_cfg import parse_darknet_cfg

        return parse_darknet_cfg(model_config_file, nclasses)
    model_config = load_yaml(model_config_file)
    if "sub_models_configs" not in model_config:
        from .compact_spec import parse_compact_model_config

        return parse_compact_model_config(model_config_file, nclasses)
    config_dir = os.path.dirname(os.path.abspath(model_config_file))
    sub_models = tuple(
        _parse_sub_model(sc, nclasses, config_dir)
        for sc in model_config["sub_models_configs"]
    )
    return ModelSpec(
        sub_models=sub_models,
        output_stage=model_config.get("output_stage", "head"),
        decay_factor=float(model_config.get("decay_factor", 0.0)),
        grid_sizes=tuple(model_config.get("grid_sizes", ())),
        nclasses=int(nclasses),
    )
