"""The seeded weights both sides get: made on the run's device from
``--seed`` in a few large draws, as a model is served (float32 masters; the
port casts them for its tier).

  * kernels: Keras' default, glorot-uniform, ``U(±sqrt(6 / (k²·cin +
    k²·cout)))`` (the JAX package's and the port's initializer);
  * BatchNorm gamma ``U(0.8, 1.2)``, beta ``U(−0.2, 0.2)``, the heads'
    biases ``U(−0.2, 0.2)``;
  * BatchNorm running statistics: the batch statistics of a forward over
    ``STATS_IMAGES`` seeded images through the plain reference, each layer
    normalized by its own. A freshly initialized model keeps mean 0 and
    variance 1, under which 75 unnormalized layers shrink the heads to
    logits near 0 and every score to about 0.25; trained statistics keep
    activations near unit scale, so scores spread and a precision loss shows
    in them.

The result is the port's nested-dict layout, ``params[sm]["layer<i>"] =
{"kernel" (OIHW), "bn": {"gamma", "beta"}}`` or ``{"kernel", "bias"}``, and
``state[sm]["layer<i>"] = {"mean", "var"}``: plain data, the same tensors
handed to the port and to the reference.
"""

from __future__ import annotations

import torch

from .reference.graph import conv_shapes
from .reference.model import TrainOps, run_graph

STATS_IMAGES = 4


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % 2**63)


def _split(flat, shapes):
    out, at = [], 0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        out.append(flat[at:at + n].view(shape))
        at += n
    return out


@torch.no_grad()
def make_weights(graph, nclasses: int, seed: int, image_size: int, device):
    """→ (params, state), see the module's doc."""
    shapes = conv_shapes(graph)
    keys = sorted(shapes)
    has_bn = {key: bool(graph_layer(graph, key).get("batch_normalize")) for key in keys}
    kshapes = [(co, ci, k, k) for co, ci, k in (shapes[key] for key in keys)]
    g = generator(device, seed, 1)
    kernels = _split(torch.rand(sum(co * ci * k * k for co, ci, k, _ in kshapes), generator=g,
                                device=device), kshapes)
    couts = [shapes[key][0] for key in keys]
    u = _split(torch.rand(2 * sum(couts), generator=g, device=device),
               [(c,) for c in couts] * 2)
    params, state = {}, {}
    for j, key in enumerate(keys):
        co, ci, k = shapes[key]
        limit = (6.0 / (k * k * ci + k * k * co)) ** 0.5
        entry = {"kernel": kernels[j] * (2 * limit) - limit}
        if has_bn[key]:
            entry["bn"] = {"gamma": 0.8 + 0.4 * u[j], "beta": 0.4 * u[len(keys) + j] - 0.2}
            state.setdefault(key[0], {})[f"layer{key[1]}"] = {
                "mean": torch.zeros(co, device=device), "var": torch.ones(co, device=device)}
        else:
            entry["bias"] = 0.4 * u[j] - 0.2
        params.setdefault(key[0], {})[f"layer{key[1]}"] = entry
    images = torch.randint(0, 256, (STATS_IMAGES, image_size, image_size, 3), generator=g,
                           device=device).float() / 255.0
    ops = TrainOps(params, state, nclasses, momentum=0.0)
    run_graph(graph, images, ops)
    for sm, layers in ops.new_state.items():
        for name, st in layers.items():
            state[sm][name] = {"mean": st["mean"].clone(), "var": st["var"].clone()}
    return params, state


def graph_layer(graph, key):
    sm, i = key
    return next(s for s in graph if s["name"] == sm)["layers"][i]
