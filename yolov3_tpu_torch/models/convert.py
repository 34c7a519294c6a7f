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

A whole train state crosses with ``train_state_to_jax`` /
``train_state_from_jax``: params, BN state, step, the EMA shadow, and the
optimizer moments (kernel-shaped, so they change layout with the kernels).
The JAX package keeps its optimizer state as nested tuples whose positions
its checkpoints flatten by index; ``_opt_to_tree`` builds exactly that
nesting, so one ``.train_state.npz`` resumes in either package.
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


def _opt_to_tree(opt_state, optimizer, leaf_fn, kernel_fn):
    """The port's optimizer-state dict → the JAX package's nesting: Adam
    ``((count, mu, nu), ())``, SGD ``((trace,), ())``; behind a clip
    ``((), base)``; scheduled ``(count, {"learning_rate"}, {}, base)``."""
    moments = lambda name: _leaves(opt_state[name], leaf_fn, kernel_fn)  # noqa: E731
    if optimizer.kind == "adam":
        base = ((leaf_fn(opt_state["count"]), moments("mu"), moments("nu")), ())
    else:
        base = ((moments("trace"),), ())
    if optimizer.grad_clip_norm:
        base = ((), base)
    if optimizer.scheduled:
        base = (leaf_fn(opt_state["inject_count"]),
                {"learning_rate": leaf_fn(opt_state["learning_rate"])}, {}, base)
    return base


def _opt_from_tree(tree, optimizer, leaf_fn, kernel_fn):
    state = {}
    if optimizer.scheduled:
        state["inject_count"] = leaf_fn(tree[0])
        state["learning_rate"] = leaf_fn(tree[1]["learning_rate"])
        tree = tree[3]
    if optimizer.grad_clip_norm:
        tree = tree[1]
    inner = tree[0]
    if optimizer.kind == "adam":
        state["count"] = leaf_fn(inner[0])
        state["mu"] = _leaves(inner[1], leaf_fn, kernel_fn)
        state["nu"] = _leaves(inner[2], leaf_fn, kernel_fn)
    else:
        state["trace"] = _leaves(inner[0], leaf_fn, kernel_fn)
    return state


def train_state_to_jax(train_state, optimizer):
    """The port's train state → a JAX-layout tree of numpy arrays (HWIO
    kernels and moments, the optimizer state nested as the JAX package's)."""
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    p_np, s_np = params_to_jax(train_state["params"], train_state["bn_state"])
    tree = {"params": p_np, "bn_state": s_np,
            "opt_state": _opt_to_tree(train_state["opt_state"], optimizer, to_np, _kernel_to_jax),
            "step": to_np(train_state["step"])}
    if "ema" in train_state:
        e_p, e_s = params_to_jax(train_state["ema"]["params"], train_state["ema"]["bn_state"])
        tree["ema"] = {"params": e_p, "bn_state": e_s}
    return tree


def train_state_from_jax(tree, optimizer, device="cpu"):
    """A JAX-layout train state (numpy arrays, or anything ``np.asarray``
    takes; the optimizer state as the JAX package nests it) → the port's,
    with params, BN state, moments and EMA on ``device`` and the counters
    and learning rate on the CPU."""
    on_dev = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    on_cpu = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    k_dev = lambda k: _kernel_to_torch(k).to(device)  # noqa: E731
    opt = _opt_from_tree(tree["opt_state"], optimizer, on_dev, k_dev)
    for name in ("count", "inject_count", "learning_rate"):
        if name in opt:
            opt[name] = opt[name].cpu()
    ts = {"params": _leaves(tree["params"], on_dev, k_dev),
          "bn_state": _leaves(tree["bn_state"], on_dev, k_dev),
          "opt_state": opt, "step": on_cpu(tree["step"]).to(torch.int32)}
    if "ema" in tree:
        ts["ema"] = {"params": _leaves(tree["ema"]["params"], on_dev, k_dev),
                     "bn_state": _leaves(tree["ema"]["bn_state"], on_dev, k_dev)}
    return ts
