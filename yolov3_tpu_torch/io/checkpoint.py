"""Native ``.npz`` checkpoints in the JAX package's key layout, numpy only,
and the legacy Keras TF-format checkpoint reader.

Counterpart of ``yolov3_tpu/io/checkpoint.py`` (no Orbax interop): one
``.npz`` of flattened tree leaves keyed by '/'-joined paths plus a JSON
manifest, written atomically. The trees here are JAX-layout numpy trees
(HWIO kernels); ``models/convert.py`` turns them into the port's tensors,
so one file serves both packages. ``save_train_state`` / ``load_train_state``
do that for a whole train state (params, BN state, optimizer moments, step,
EMA): the file they write is the JAX package's ``.train_state.npz``, its
optimizer state flattened by position, and either package resumes the other's.

Legacy reader: maps a Keras ``save_weights`` TF-format checkpoint (the
reference's output, e.g. ``checkpoints/...yolov3_train.tf``) onto the port's
(params, state) trees. Keras object paths follow creation order —
``layer_with_weights-<i>`` = i-th weighted sub-model in config order, nested
``layer_with_weights-<j>`` = j-th weighted layer (conv / BN) within it — so
the mapping is reconstructed from the ModelSpec. Reading the bundle needs
TensorFlow (checked, not imported, until a checkpoint is read).
"""

from __future__ import annotations

import importlib.util
import json
import os
import tempfile

import numpy as np

_MANIFEST_KEY = "__manifest__"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_checkpoint(path: str, tree, step: int | None = None):
    """Save a tree of numpy arrays atomically (write-to-temp + rename)."""
    flat = _flatten(tree)
    manifest = {"step": step, "keys": sorted(flat)}
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat, **{_MANIFEST_KEY: json.dumps(manifest)})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def checkpoint_keys(path: str):
    """Array key names of a native checkpoint without loading the arrays."""
    with np.load(path, allow_pickle=False) as z:
        return [k for k in z.files if k != _MANIFEST_KEY]


def load_checkpoint(path: str, like=None, partial: bool = False):
    """Load a native checkpoint → ``(tree, step)``. With ``like`` (a template
    tree of numpy arrays) leaves are restored into its structure and dtypes;
    ``partial`` keeps template leaves the file lacks (Keras expect_partial).
    Without ``like`` a nested dict is built from the keys."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != _MANIFEST_KEY}
        step = None
        if _MANIFEST_KEY in z.files:
            step = json.loads(str(z[_MANIFEST_KEY])).get("step")

    if like is not None:
        like_flat = _flatten(like)
        missing = set(like_flat) - set(flat)
        if missing and not partial:
            raise ValueError(f"checkpoint {path} missing keys: {sorted(missing)[:5]}…")
        if missing and not (set(like_flat) & set(flat)):
            raise ValueError(f"checkpoint {path} matched no template keys")
        return _unflatten_like(like, flat), step
    return _nest(flat), step


def _unflatten_like(like, flat, prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return tuple(_unflatten_like(v, flat, f"{prefix}{i}/") for i, v in enumerate(like))
    arr = flat.get(prefix[:-1])
    if arr is None:  # partial load: keep the template's value
        return like
    like = np.asarray(like)
    if arr.shape != like.shape:
        raise ValueError(f"checkpoint leaf {prefix[:-1]}: shape {arr.shape} "
                         f"!= model {like.shape}")
    return arr.astype(like.dtype)


def _nest(flat):
    root = {}
    for key, val in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def save_train_state(path: str, train_state, optimizer, step: int | None = None):
    """The port's full train state → ``path`` in the JAX package's key layout."""
    from ..models.convert import train_state_to_jax

    save_checkpoint(path, train_state_to_jax(train_state, optimizer), step=step)


def load_train_state(path: str, like, optimizer, device="cpu"):
    """Load a full train state into the structure of ``like`` (a train state
    of the port, e.g. a fresh ``init_train_state``) → ``(train_state, step)``.
    Strict: a missing key raises, so a resume never drops optimizer state."""
    from ..models.convert import train_state_from_jax, train_state_to_jax

    tree, step = load_checkpoint(path, like=train_state_to_jax(like, optimizer))
    return train_state_from_jax(tree, optimizer, device), step


# ---------------------------------------------------------------------------
# Legacy Keras TF-format checkpoint reader
# ---------------------------------------------------------------------------


def _weighted_layer_paths(spec):
    """Keras object-graph paths for every weight, in spec order.

    Returns list of (keras_path, kind, sm_name, layer_key, leaf) where kind ∈
    {kernel, bias, gamma, beta, moving_mean, moving_variance}.
    """
    entries = []
    sm_widx = 0  # Keras numbers only sub-models that HOLD weights — a
    # conv-free sub-model (route/upsample-only) is skipped in its
    # layer_with_weights numbering, so track the weighted index separately
    for sm in spec.sub_models:
        if not any(layer.kind == "convolutional" for layer in sm.layers):
            continue
        sm_idx = sm_widx
        sm_widx += 1
        wl = 0  # layer_with_weights index within the sub-model
        for i, layer in enumerate(sm.layers):
            if layer.kind != "convolutional":
                continue
            base = f"layer_with_weights-{sm_idx}/layer_with_weights-{wl}"
            entries.append((f"{base}/kernel", "kernel", sm.name, f"layer{i}", "kernel"))
            if layer["batch_normalize"]:
                wl += 1
                bnbase = f"layer_with_weights-{sm_idx}/layer_with_weights-{wl}"
                entries.append((f"{bnbase}/gamma", "gamma", sm.name, f"layer{i}", "gamma"))
                entries.append((f"{bnbase}/beta", "beta", sm.name, f"layer{i}", "beta"))
                entries.append((f"{bnbase}/moving_mean", "moving_mean", sm.name, f"layer{i}",
                                "mean"))
                entries.append((f"{bnbase}/moving_variance", "moving_variance", sm.name,
                                f"layer{i}", "var"))
            else:
                entries.append((f"{base}/bias", "bias", sm.name, f"layer{i}", "bias"))
            wl += 1
    return entries


def load_tf_keras_checkpoint(spec, params, state, prefix: str):
    """Restore a Keras save_weights (TF format) checkpoint into the port's
    (params, state) trees, in place → ``(params, state, loaded)``. HWIO
    kernels become OIHW tensors; every value keeps its bits.

    Partial restores are tolerated (expect_partial semantics — reference
    inference.py:102): missing variables are left at their current values.
    Raises ``ImportError`` where TensorFlow is not installed.
    """
    import torch

    from ..models.convert import _kernel_to_torch

    if importlib.util.find_spec("tensorflow") is None:
        raise ImportError(
            "Reading legacy Keras TF-format checkpoints requires tensorflow; convert the "
            "checkpoint once with python -m yolov3_tpu_torch.tools.convert_tf_checkpoint "
            "where tensorflow is installed")
    from tensorflow.python.training import py_checkpoint_reader

    reader = py_checkpoint_reader.NewCheckpointReader(prefix)
    var_map = reader.get_variable_to_shape_map()
    suffix = "/.ATTRIBUTES/VARIABLE_VALUE"
    loaded = 0
    for keras_path, kind, sm_name, layer_key, leaf in _weighted_layer_paths(spec):
        full = keras_path + suffix
        if full not in var_map:
            continue
        value = reader.get_tensor(full)
        if kind == "kernel":
            params[sm_name][layer_key]["kernel"] = _kernel_to_torch(value)
        elif kind == "bias":
            params[sm_name][layer_key]["bias"] = torch.from_numpy(np.array(value))
        elif kind in ("gamma", "beta"):
            params[sm_name][layer_key]["bn"][kind] = torch.from_numpy(np.array(value))
        else:
            state[sm_name][layer_key][leaf] = torch.from_numpy(np.array(value, np.float32))
        loaded += 1
    return params, state, loaded
