"""Native ``.npz`` checkpoints in the JAX package's key layout, numpy only.

Counterpart of ``yolov3_tpu/io/checkpoint.py`` (native format only): one
``.npz`` of flattened tree leaves keyed by '/'-joined paths plus a JSON
manifest, written atomically. The trees here are JAX-layout numpy trees
(HWIO kernels); ``models/convert.py`` turns them into the port's tensors,
so one file serves both packages.
"""

from __future__ import annotations

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
