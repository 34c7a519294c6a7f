"""Space-to-depth stem rewrite — a bit-exact inference-time transform.

Counterpart of ``yolov3_tpu/ops/s2d.py::s2d_stem``. The Darknet-53 stem
(conv0 3×3 s1 3→32 at 416², conv1 3×3 s2 32→64) works at the image's full
resolution for under 1% of the model's operations. This transform rewrites
the pair so all activations live on the 208² grid with the 2×2 spatial
phases stacked into channels:

  * conv0 → a 4×4 stride-2 conv 3→4·32 applied directly to the 416² input
    with padding ((1,2),(1,2)). Output pixel (2I+pi, 2J+pj) of the original
    conv0 reads input rows 2I+pi-1 … 2I+pi+1 ⊆ {2I-1 … 2I+2} — a 4-row
    window at stride 2 — so stacking the 4 (pi,pj) phases as output-channel
    groups turns conv0 into one strided conv whose output is the original
    416²×32 activation in phase-stacked (208,208,128) layout. The kernel is
    the original 3×3 kernel placed at offset (pi,pj) per phase group
    (structural zeros elsewhere); per-channel scales/biases tile ×4.
  * conv1 (3×3 s2, Darknet top-left pad) → a 2×2 stride-1 conv 4·32→64 with
    padding ((1,0),(1,0)) over the phase-stacked tensor: its 3-row window
    rows 2o-1 … 2o+1 spans phase-cells {o-1, o}. Output lands on the normal
    (208,208,64) grid, so everything downstream is untouched.

Both rewritten convs sum exactly the same int32 products as the originals
(plus structural zeros), and the fp epilogues are elementwise with
per-channel params tiled across phases — the int8 outputs are bit-equal.
On the card both go to the k×k int8 kernel (``ops/cuda/conv_int8.py``).

Applies only when the model's first two layers are int8-quantized convs
matching the Darknet stem pattern (3×3 s1 then 3×3 s2); otherwise a no-op —
yolov3-tiny's maxpool stem, fp models and mixed-precision configs that keep
the stem in fp all pass through unchanged. The training-mode rewrite
``s2d_stem_train`` is spec only: the fp forward builds the phase kernels
from the original ones (``models/layers.py::s2d_phase_kernel_conv{0,1}``).

Kernels here are the port's quantized layout, (cout, kh, kw, cin).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.spec import LayerSpec, ModelSpec, SubModelSpec, _attrs


def _rewrite_conv0_kernel(k):
    """(cout,3,3,cin) → (4·cout,4,4,cin): phase-stacked strided stem conv."""
    k = np.asarray(k)
    cout, _, _, cin = k.shape
    out = np.zeros((4 * cout, 4, 4, cin), k.dtype)
    for pi in range(2):
        for pj in range(2):
            g = pi * 2 + pj
            out[g * cout:(g + 1) * cout, pi:pi + 3, pj:pj + 3, :] = k
    return out


def _rewrite_conv1_kernel(k):
    """(cout,3,3,cin) → (cout,2,2,4·cin): phase-consuming 2×2 conv."""
    k = np.asarray(k)
    cout, _, _, cin = k.shape
    out = np.zeros((cout, 2, 2, 4 * cin), k.dtype)
    for qi in range(2):
        for qj in range(2):
            g = qi * 2 + qj
            for cdi in range(2):
                for cdj in range(2):
                    di = 2 * (cdi - 1) + qi + 1
                    dj = 2 * (cdj - 1) + qj + 1
                    if 0 <= di <= 2 and 0 <= dj <= 2:
                        out[:, cdi, cdj, g * cin:(g + 1) * cin] = k[:, di, dj]
    return out


def _layer_with(layer: LayerSpec, **updates) -> LayerSpec:
    d = {k: v for k, v in layer.attrs}
    d.update(updates)
    return LayerSpec(kind=layer.kind, attrs=_attrs(d))


def _find_stem(sm: SubModelSpec):
    """Index of the first conv of a structurally rewritable Darknet stem,
    or None. (Callers add their own param-format checks.)

    The stem pair is the first convolutional layer (any input-selecting
    routes before it are untouched — their outputs are the raw images) and
    the layer immediately after it. The first conv's output changes layout,
    so nothing else may reference it."""
    i0 = next((i for i, l in enumerate(sm.layers) if l.kind == "convolutional"), None)
    if i0 is None or i0 + 1 >= len(sm.layers):
        return None
    if any(l.kind != "route" for l in sm.layers[:i0]):
        return None
    l0, l1 = sm.layers[i0], sm.layers[i0 + 1]
    if l1.kind != "convolutional":
        return None
    if not (l0.get("size") == 3 and l0.get("stride") == 1 and l0.get("pad", 1) == 1):
        return None
    if not (l1.get("size") == 3 and l1.get("stride") == 2):
        return None
    n = len(sm.layers)
    if any(i % n == i0 for i in sm.outputs_layers):  # outputs_layers: end-relative
        return None
    for j, layer in enumerate(sm.layers):
        # route/shortcut indices resolve against layer_outs (length j at
        # layer j — network.py): non-negative = absolute layer index,
        # negative = relative to the current position (j + i), NOT
        # end-relative.
        if layer.kind == "shortcut":
            frm = int(layer["from"])
            if (frm if frm >= 0 else j + frm) == i0:
                return None
        if layer.kind == "route":
            src = dict(layer["source"])
            for i in src.get("layers", ()):
                i = int(i)
                if (i if i >= 0 else j + i) == i0:
                    return None
    return i0


def _rewritten(tensor, fn):
    return torch.from_numpy(fn(tensor.detach().cpu().numpy())).to(tensor.device)


def s2d_stem(spec: ModelSpec, params, image_size: int | None = None):
    """Apply the space-to-depth stem rewrite. Returns ``(spec, params)`` —
    new objects when the first sub-model matches the Darknet int8 stem
    pattern, the inputs unchanged otherwise. ``params`` must be quantized
    (``quantize_params`` output); state must already be folded.

    The rewrite is exact only for EVEN input heights/widths (at odd sizes
    the phase decomposition produces one extra output row/column vs the
    original stem). Every real YOLO resolution is a multiple of 32, but
    pass ``image_size`` when known — odd sizes then no-op instead of
    changing the output geometry."""
    if image_size is not None and image_size % 2:
        return spec, params
    sm0 = spec.sub_models[0]
    sm_params = params.get(sm0.name, {})
    i0 = _find_stem(sm0)
    if i0 is not None and (
        "kernel_q" not in sm_params.get(f"layer{i0}", {})
        or "kernel_q" not in sm_params.get(f"layer{i0 + 1}", {})
    ):
        i0 = None  # stem not int8-quantized (fp model / mixed precision)
    if i0 is None:
        return spec, params

    l0, l1 = sm0.layers[i0], sm0.layers[i0 + 1]
    p0, p1 = sm_params[f"layer{i0}"], sm_params[f"layer{i0 + 1}"]

    new_l0 = _layer_with(l0, size=4, stride=2, filters=4 * l0["filters"],
                         explicit_pad=((1, 2), (1, 2)))
    new_l1 = _layer_with(l1, size=2, stride=1, explicit_pad=((1, 0), (1, 0)))

    new_p0 = dict(p0)
    new_p0["kernel_q"] = _rewritten(p0["kernel_q"], _rewrite_conv0_kernel)
    new_p0["w_scale"] = p0["w_scale"].repeat(4)
    new_p0["bias"] = p0["bias"].repeat(4)
    new_p1 = dict(p1)
    new_p1["kernel_q"] = _rewritten(p1["kernel_q"], _rewrite_conv1_kernel)

    new_sm0 = SubModelSpec(
        name=sm0.name,
        layers=tuple(sm0.layers[:i0]) + (new_l0, new_l1) + tuple(sm0.layers[i0 + 2:]),
        inputs=sm0.inputs,
        outputs_layers=sm0.outputs_layers,
        input_shape=sm0.input_shape,
    )
    new_spec = ModelSpec(
        sub_models=(new_sm0,) + tuple(spec.sub_models[1:]),
        output_stage=spec.output_stage,
        decay_factor=spec.decay_factor,
        grid_sizes=spec.grid_sizes,
        nclasses=spec.nclasses,
    )
    new_params = dict(params)
    new_params[sm0.name] = {**sm_params, f"layer{i0}": new_p0, f"layer{i0 + 1}": new_p1}
    return new_spec, new_params


def s2d_stem_train(spec: ModelSpec, image_size: int | None = None) -> ModelSpec:
    """Training-mode stem rewrite: spec only, params untouched.

    The geometry of ``s2d_stem`` applied to the fp training forward: the two
    stem layers are tagged ``s2d_phase`` ("conv0", "conv1") and
    ``models/network.py`` builds the phase kernels inside the differentiated
    graph from the ORIGINAL 3×3 kernels (linear, so the gradients land on
    the original params). conv0's BN reduces over the 4 spatial-phase channel
    groups (``batch_norm(phases=4)``): the same per-channel statistics as the
    un-rewritten layout. Params, optimizer state, checkpoints and L2 are the
    same tree; init and checkpoint loading use the ORIGINAL spec, and only
    the step functions take the rewritten one.

    Requires BN on conv0 (a per-channel bias would not tile across phases).
    No-op (returns ``spec``) when the pattern does not match: tiny's maxpool
    stem, odd image sizes, custom models.
    """
    if image_size is not None and image_size % 2:
        return spec
    sm0 = spec.sub_models[0]
    i0 = _find_stem(sm0)
    if i0 is None:
        return spec
    l0, l1 = sm0.layers[i0], sm0.layers[i0 + 1]
    if not l0.get("batch_normalize"):
        return spec

    new_l0 = _layer_with(l0, size=4, stride=2, filters=4 * l0["filters"],
                         explicit_pad=((1, 2), (1, 2)), s2d_phase="conv0")
    new_l1 = _layer_with(l1, size=2, stride=1, explicit_pad=((1, 0), (1, 0)),
                         s2d_phase="conv1")
    new_sm0 = SubModelSpec(
        name=sm0.name,
        layers=tuple(sm0.layers[:i0]) + (new_l0, new_l1) + tuple(sm0.layers[i0 + 2:]),
        inputs=sm0.inputs,
        outputs_layers=sm0.outputs_layers,
        input_shape=sm0.input_shape,
    )
    return ModelSpec(
        sub_models=(new_sm0,) + tuple(spec.sub_models[1:]),
        output_stage=spec.output_stage,
        decay_factor=spec.decay_factor,
        grid_sizes=spec.grid_sizes,
        nclasses=spec.nclasses,
    )
