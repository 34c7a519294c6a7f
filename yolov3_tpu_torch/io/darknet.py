"""Darknet ``.weights`` files ↔ the port's (params, state) trees.

Counterpart of ``yolov3_tpu/io/darknet.py``; the file layout is the same
(reference convert.py:36-137):
  * 5 little-endian int32 header (major, minor, revision, seen ×2);
  * per conv layer, in spec order (sub-models in config order, layers in
    file order):
      - if followed by BN: 4×filters float32 stored [beta, gamma, mean, var];
      - else: filters float32 bias;
      - then the kernel as (out, in, kh, kw) float32 — the port's own OIHW
        layout, so it is read and written as it lies.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.network import _infer_channels, init_model
from ..models.spec import ModelSpec

_HEADER = np.array([0, 2, 0, 0, 0], np.int32)


def _conv_layers(spec: ModelSpec):
    """(sub-model name, layer index, layer) of every conv, in file order."""
    for sm in spec.sub_models:
        for i, layer in enumerate(sm.layers):
            if layer.kind == "convolutional":
                yield sm.name, i, layer


def load_darknet_weights(spec: ModelSpec, weights_file: str, dtype=torch.float32):
    """Read a Darknet .weights file into (params, state) CPU trees: a template
    from ``init_model`` (seed 0), every leaf of it then overwritten. Raises
    ``ValueError`` on a truncated file or on floats left over once every conv
    is read (a model/weights mismatch)."""
    params, state = init_model(spec, torch.Generator().manual_seed(0), dtype)
    per_layer = _infer_channels(spec)

    with open(weights_file, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=5)
        if header.size != 5:
            raise ValueError(f"{weights_file}: truncated darknet header")
        floats = np.fromfile(f, dtype=np.float32)
    offset = 0

    def take(count, what):
        nonlocal offset
        if offset + count > floats.size:
            raise ValueError(f"{weights_file}: truncated {what}")
        chunk = floats[offset:offset + count]
        offset += count
        return chunk

    for sm_name, i, layer in _conv_layers(spec):
        cin, cout = per_layer[(sm_name, i)]
        k = layer["size"]
        entry = params[sm_name][f"layer{i}"]
        where = f"{sm_name}/layer{i}"
        if layer["batch_normalize"]:
            beta, gamma, mean, var = take(4 * cout, f"BN block at {where}").reshape(4, cout)
            entry["bn"]["gamma"] = torch.from_numpy(gamma).to(dtype)
            entry["bn"]["beta"] = torch.from_numpy(beta).to(dtype)
            st = state[sm_name][f"layer{i}"]
            st["mean"] = torch.from_numpy(mean)
            st["var"] = torch.from_numpy(var)
        else:
            entry["bias"] = torch.from_numpy(take(cout, f"bias at {where}")).to(dtype)
        kernel = take(cout * cin * k * k, f"kernel at {where}").reshape(cout, cin, k, k)
        entry["kernel"] = torch.from_numpy(kernel).to(dtype)

    if offset != floats.size:
        raise ValueError(
            f"{weights_file}: {floats.size - offset} floats left after loading all conv "
            "layers (model/weights mismatch)")
    return params, state


def save_darknet_weights(spec: ModelSpec, params, state, weights_file: str):
    """Inverse of ``load_darknet_weights``: the same bytes the JAX package's
    ``save_darknet_weights`` writes for the same values."""
    as_f32 = lambda t: t.detach().cpu().to(torch.float32).numpy()  # noqa: E731
    chunks = [_HEADER.tobytes()]
    for sm_name, i, _ in _conv_layers(spec):
        entry = params[sm_name][f"layer{i}"]
        if "bn" in entry:
            st = state[sm_name][f"layer{i}"]
            chunks.append(np.stack([as_f32(entry["bn"]["beta"]), as_f32(entry["bn"]["gamma"]),
                                    as_f32(st["mean"]), as_f32(st["var"])]).tobytes())
        else:
            chunks.append(as_f32(entry["bias"]).tobytes())
        chunks.append(as_f32(entry["kernel"]).tobytes())
    with open(weights_file, "wb") as f:
        f.write(b"".join(chunks))
