"""Checkpoint path resolution for the port's trees.

Counterpart of ``yolov3_tpu/io/resolve.py``. Loading tries the exact path,
then ``path + '.npz'``, as a native checkpoint. The reference's Keras
TF-format prefixes (``path + '.index'``) need TensorFlow's bundle reader
and are not carried by this slice of the port. Saving always writes the
native format in the JAX key layout, so the JAX package reads it too.
"""

from __future__ import annotations

import os

from ..models.convert import params_from_jax, params_to_jax
from .checkpoint import load_checkpoint, save_checkpoint


def native_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_weights(spec, params, state, path: str, step=None):
    p_np, s_np = params_to_jax(params, state)
    save_checkpoint(native_path(path), {"params": p_np, "bn_state": s_np}, step=step)


def load_weights(spec, params, state, path: str):
    """Load into existing CPU (params, state) trees; partial loads tolerated
    (expect_partial — reference inference.py:102). Returns (params, state)."""
    for candidate in (path, native_path(path)):
        if os.path.exists(candidate) and candidate.endswith(".npz"):
            p_np, s_np = params_to_jax(params, state)
            tree, _ = load_checkpoint(candidate, like={"params": p_np, "bn_state": s_np},
                                      partial=True)
            return params_from_jax(tree["params"], tree["bn_state"])
    if os.path.exists(path + ".index"):
        raise NotImplementedError(
            f"{path}: Keras TF-format checkpoints are read by a later slice of "
            "the port (io + tools); convert to .npz with the JAX package's "
            "tools/convert_tf_checkpoint.py")
    raise FileNotFoundError(f"no checkpoint found at {path}(.npz)")
