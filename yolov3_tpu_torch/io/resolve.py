"""Checkpoint path resolution for the port's trees.

Counterpart of ``yolov3_tpu/io/resolve.py``. The reference configs point at
TF-checkpoint prefixes like ``checkpoints/output/yolov3_train_tiny.tf``
(train_config.yaml:60); loading tries, in order:
  1. the exact path / path + '.npz' as a native checkpoint;
  2. path + '.index' as a Keras save_weights TF-format checkpoint
     (``checkpoint.load_tf_keras_checkpoint``; needs TensorFlow).
Saving always writes the native format in the JAX key layout (path + '.npz'
unless the path already ends in .npz), so the JAX package reads it too.
"""

from __future__ import annotations

import os

from ..models.convert import params_from_jax, params_to_jax
from .checkpoint import load_checkpoint, load_tf_keras_checkpoint, save_checkpoint


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
        params, state, loaded = load_tf_keras_checkpoint(spec, params, state, path)
        if loaded == 0:
            raise ValueError(f"TF checkpoint {path} matched no variables")
        return params, state
    raise FileNotFoundError(f"no checkpoint found at {path}(.npz/.index)")
