"""Carry weights between the JAX package's pytrees and the port's trees.

The two share keys (``params[sm][layer{i}]`` / ``state[sm][layer{i}]``);
only the conv kernel layout differs: JAX keeps HWIO
(``lax.conv_general_dilated`` with "HWIO"), PyTorch OIHW. Bias, BN
gamma/beta and running mean/var are per-channel vectors and move as they
are. Both directions go through numpy, so neither side imports the other.
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
