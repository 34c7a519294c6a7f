"""Carry weights between the JAX package's pytrees and the port's trees.

The two share keys (``params[sm][layer{i}]`` / ``state[sm][layer{i}]``);
only the conv kernel layout differs: JAX keeps HWIO
(``lax.conv_general_dilated`` with "HWIO"), PyTorch OIHW. Bias, BN
gamma/beta and running mean/var are per-channel vectors and move as they
are. Both directions go through numpy, so neither side imports the other.

Quantized params (``ops/quantize.py``) cross with ``qparams_from_jax`` /
``qparams_to_jax``: ``kernel_q`` is int8 HWIO in the JAX package and int8
(cout, kh, kw, cin) here; ``w_scale``, ``bias`` and the 0-d f32 scales
(``in_scale``, ``out_scale``, also the shortcut entries') move as they are,
and entries left in fp (the head convs) move like fp params.
"""

from __future__ import annotations

import numpy as np
import torch


def _kernel_to_torch(k_hwio) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k_hwio).transpose(3, 2, 0, 1)))


def _kernel_to_jax(k_oihw) -> np.ndarray:
    return np.ascontiguousarray(k_oihw.detach().cpu().numpy().transpose(2, 3, 1, 0))


def _leaves(tree, fn, kernel_fn):
    if isinstance(tree, dict):
        return {k: (kernel_fn(v) if k == "kernel" else _leaves(v, fn, kernel_fn))
                for k, v in tree.items()}
    return fn(tree)


def params_from_jax(params_np, state_np):
    """JAX (params, state) trees of numpy arrays → the port's CPU tensors."""
    to_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731 — own copy
    return (_leaves(params_np, to_t, _kernel_to_torch),
            _leaves(state_np, to_t, _kernel_to_torch))


def params_to_jax(params, state):
    """The port's (params, state) → JAX-layout trees of numpy arrays."""
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return (_leaves(params, to_np, _kernel_to_jax),
            _leaves(state, to_np, _kernel_to_jax))


def _qkernel_to_torch(k_hwio) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k_hwio).transpose(3, 0, 1, 2)))


def _qkernel_to_jax(k_ohwi) -> np.ndarray:
    return np.ascontiguousarray(k_ohwi.detach().cpu().numpy().transpose(1, 2, 3, 0))


def _qleaves(tree, fn, kernel_fn, qkernel_fn):
    out = {}
    for k, v in tree.items():
        if k == "kernel":
            out[k] = kernel_fn(v)
        elif k == "kernel_q":
            out[k] = qkernel_fn(v)
        elif isinstance(v, dict):
            out[k] = _qleaves(v, fn, kernel_fn, qkernel_fn)
        else:
            out[k] = fn(v)
    return out


def qparams_from_jax(qparams_np):
    """The JAX package's quantized params (numpy arrays) → the port's CPU
    tensors, every value bit for bit."""
    to_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731 — own copy
    return _qleaves(qparams_np, to_t, _kernel_to_torch, _qkernel_to_torch)


def qparams_to_jax(qparams):
    """The port's quantized params → JAX-layout trees of numpy arrays."""
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return _qleaves(qparams, to_np, _kernel_to_jax, _qkernel_to_jax)
