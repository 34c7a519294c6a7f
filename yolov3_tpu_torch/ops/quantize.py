"""Post-training int8 quantization for inference (the int8 serving tiers).

Counterpart of the PTQ half of ``yolov3_tpu/ops/quantize.py``:
  * ``calibrate_scales`` — run sample batches through the BN-folded model
    collecting every conv's input abs-max and every layer's output abs-max;
  * ``quantize_params`` — per-output-channel symmetric int8 weights +
    calibrated per-tensor input scales; BN must be folded first (bias stays
    fp32);
  * the quantized forward runs through the regular interpreter — a conv
    whose params carry ``kernel_q`` takes the int8 path
    (``models/layers.py::conv2d_int8``).

The heads' final 1×1 convs stay in fp by default (``skip_final_convs``):
box and score logits are precision-sensitive and those layers are a
negligible share of the operations.

The QAT half (``fake_quant_kernel``, ``fake_quant_activation``,
``fake_quant_weights``, ``make_activation_fake_quant``) puts the training
forward on the same int8 lattice with straight-through gradients
(``x + (q − x).detach()``), skipping the convs ``quantized_conv_skips`` names.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.network import _infer_channels, apply_model
from ..models.spec import require_activations


def head_conv_taps(spec):
    """(sm_name, layer_key) of the conv feeding each yolo layer.

    Walks backwards from EVERY yolo layer to its nearest preceding conv —
    correct for both per-sub-model head configs (one yolo per sub-model)
    and compact single-file specs where several heads share one sub-model.
    """
    taps = set()
    for sm in spec.sub_models:
        for j, layer in enumerate(sm.layers):
            if layer.kind != "yolo":
                continue
            for i in range(j - 1, -1, -1):
                if sm.layers[i].kind == "convolutional":
                    taps.add((sm.name, f"layer{i}"))
                    break
    return taps


def _params_device(params):
    """The device of a params tree: that of its first conv kernel."""
    for sm_params in params.values():
        for entry in sm_params.values():
            for name in ("kernel", "kernel_q"):
                if name in entry:
                    return entry[name].device
    raise ValueError("params hold no convolution kernel")


@torch.inference_mode()
def calibrate_scales(spec, folded_params, images_batches):
    """Calibration passes → (conv-input absmax, layer-output absmax), as
    dicts of Python floats.

    Input absmax keys: (sm_name, layer_key) of each conv's input tensor.
    Output absmax keys: (sm_name, layer_key) of EVERY layer's output (after
    activation) — the requant scale when conv chains stay int8. The forward
    runs on the device of ``folded_params``; the taps of a batch come back
    to the host in one transfer.
    """
    device = _params_device(folded_params)
    in_absmax: dict = {}
    out_absmax: dict = {}
    for images in images_batches:
        in_taps, out_taps = {}, {}

        def in_obs(sm_name, layer_key, x):
            in_taps[(sm_name, layer_key)] = x.to(torch.float32).abs().max()

        def out_obs(sm_name, layer_key, x):
            out_taps[(sm_name, layer_key)] = x.to(torch.float32).abs().max()

        apply_model(spec, folded_params, {}, torch.as_tensor(images, device=device),
                    conv_observer=in_obs, out_observer=out_obs)
        for acc, taps in ((in_absmax, in_taps), (out_absmax, out_taps)):
            values = torch.stack(list(taps.values())).cpu().tolist()
            for key, val in zip(taps, values):
                acc[key] = max(acc.get(key, 0.0), float(val))
    return in_absmax, out_absmax


def calibrate_activation_scales(spec, folded_params, images_batches):
    """Per-conv input abs-max over calibration batches → {(sm, layer): float}."""
    return calibrate_scales(spec, folded_params, images_batches)[0]


def quantized_conv_skips(spec, skip_final_convs: bool = True, min_k2cin: int = 0):
    """Set of ``(sm_name, layer_key)`` conv taps the int8 serving tier leaves
    in fp: the final head convs (``skip_final_convs``) plus convs whose
    contraction size kernel²·Cin is below ``min_k2cin``."""
    skips = head_conv_taps(spec) if skip_final_convs else set()
    if min_k2cin:
        per_layer = _infer_channels(spec)
        for sm in spec.sub_models:
            for i, layer in enumerate(sm.layers):
                if layer.kind != "convolutional":
                    continue
                cin, _ = per_layer[(sm.name, i)]
                if layer["size"] ** 2 * cin < min_k2cin:
                    skips.add((sm.name, f"layer{i}"))
    return skips


def _scale(absmax: float, device) -> torch.Tensor:
    """absmax / 127 as the JAX package takes it: the Python-float quotient in
    f64 first, then one rounding to a 0-d f32 tensor."""
    return torch.tensor(absmax / 127.0, dtype=torch.float32, device=device)


def quantize_params(spec, folded_params, act_absmax, skip_final_convs: bool = True,
                    out_absmax=None, min_k2cin: int = 0):
    """BN-folded params → int8-quantized params, on the device of the input.

    Per-output-channel symmetric weight quantization; activation scale =
    calibrated absmax / 127. Convs flagged for skipping (final head convs)
    keep their fp params. A quantized entry holds ``kernel_q`` int8 (cout,
    kh, kw, cin), ``w_scale`` (cout,) f32, ``in_scale`` () f32 and ``bias``
    (cout,) f32.

    With ``out_absmax`` (layer-output absmax from ``calibrate_scales``),
    chain mode: each quantized conv additionally carries ``out_scale`` so
    its epilogue emits int8 directly, and each shortcut layer gets an
    ``out_scale`` entry for the dequant-add-requant — activations then stay
    int8 end to end between convs.

    ``min_k2cin``: skip convs whose contraction size kernel²·Cin is below
    this threshold (mixed precision for the stem layers).
    """
    require_activations(spec, ("linear", "leaky"), "int8 quantization")
    final_convs = quantized_conv_skips(spec, skip_final_convs, min_k2cin)
    device = _params_device(folded_params)

    qparams = {}
    for sm in spec.sub_models:
        sm_q = {}
        for key, entry in folded_params[sm.name].items():
            tap = (sm.name, key)
            if tap in final_convs or tap not in act_absmax or act_absmax[tap] <= 0:
                sm_q[key] = dict(entry)
                continue
            kernel = entry["kernel"].detach().to("cpu", torch.float32).numpy()  # OIHW
            w_absmax = np.maximum(np.abs(kernel).max(axis=(1, 2, 3)), 1e-12)  # (cout,)
            w_scale = w_absmax / 127.0
            kernel_q = np.clip(np.round(kernel / w_scale[:, None, None, None]),
                               -127, 127).astype(np.int8)
            bias = entry.get("bias")
            sm_q[key] = {
                "kernel_q": torch.from_numpy(
                    np.ascontiguousarray(kernel_q.transpose(0, 2, 3, 1))).to(device),
                "w_scale": torch.from_numpy(w_scale.astype(np.float32)).to(device),
                "in_scale": _scale(act_absmax[tap], device),
                "bias": (torch.zeros(kernel.shape[0], device=device) if bias is None
                         else bias.detach().to(device, torch.float32)),
            }
            if out_absmax is not None and out_absmax.get(tap, 0.0) > 0:
                sm_q[key]["out_scale"] = _scale(out_absmax[tap], device)
        if out_absmax is not None:
            for i, layer in enumerate(sm.layers):
                key = f"layer{i}"
                tap = (sm.name, key)
                if layer.kind == "shortcut" and out_absmax.get(tap, 0.0) > 0:
                    sm_q[key] = {"out_scale": _scale(out_absmax[tap], device)}
        qparams[sm.name] = sm_q
    return qparams


# ---------------------------------------------------------------------------
# Quantization-aware training (QAT): fake quantization, straight-through
# ---------------------------------------------------------------------------

_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def fake_quant_kernel(kernel):
    """Straight-through-estimator fake-quant of one OIHW conv kernel.

    Forward: snap to the per-output-channel symmetric int8 lattice, exactly
    ``quantize_params``' weight scheme (absmax over (cin, kh, kw) / 127, round
    half to even, clip ±127), in f32 with a true division. Backward: identity,
    so the f32 master keeps training through the rounding. BN folding scales a
    kernel's output channel by one factor, which scales its absmax alike: the
    integers after folding are ± those before, so this trains against the
    weight error the int8 serving tier realizes.

    The scale is absmax · f32(1/127): XLA compiles the JAX package's
    ``/ 127.0`` into that product, which can differ from the quotient by one
    ulp and so move an integer."""
    k32 = kernel.to(torch.float32)
    w_scale = torch.clamp(k32.abs().amax(dim=(1, 2, 3), keepdim=True), min=1e-12) * _INV_127
    q = torch.clamp(torch.round(k32 / w_scale), -127, 127) * w_scale
    return kernel + (q.to(kernel.dtype) - kernel).detach()


def fake_quant_activation(x, absmax=None):
    """STE fake-quant of one activation on the serving int8 lattice: one
    per-tensor scale, the batch's absmax / 127 (serving uses the calibrated
    absmax; training adapts to the rounding), round half to even, clip ±127,
    the scale math in f32 whatever ``x``'s dtype (absmax · f32(1/127), as
    ``fake_quant_kernel``). Backward: identity. ``absmax``: the whole
    activation's, when ``x`` is one band of it (``parallel/spatial.py``)."""
    x32 = x.to(torch.float32)
    if absmax is None:
        absmax = x32.abs().amax()
    scale = torch.clamp(absmax, min=1e-12) * _INV_127
    q = torch.clamp(torch.round(x32 / scale), -127, 127) * scale
    return x + (q.to(x.dtype) - x).detach()


def make_activation_fake_quant(spec, skip_final_convs: bool = True, min_k2cin: int = 0):
    """→ ``transform(sm_name, layer_key, x)`` for ``apply_model``'s
    ``conv_input_transform``: fake-quants the input of every conv the int8
    serving tier quantizes; the skipped convs' inputs pass through. ``x``
    may be the list of an activation's bands (``parallel/spatial.py``): one
    scale, from the absmax over them all, quantizes each."""
    skips = quantized_conv_skips(spec, skip_final_convs, min_k2cin)

    def transform(sm_name, layer_key, x):
        if (sm_name, layer_key) in skips:
            return x
        if isinstance(x, list):
            dev = x[0].device
            absmax = torch.stack([part.to(torch.float32).abs().amax().to(dev)
                                  for part in x]).amax()
            return [fake_quant_activation(part, absmax.to(part.device)) for part in x]
        return fake_quant_activation(x)

    return transform


def fake_quant_weights(spec, params, skip_final_convs: bool = True, min_k2cin: int = 0):
    """Fake-quant every conv kernel the int8 serving tier quantizes; the
    skipped convs (``quantized_conv_skips``), BN parameters and biases are
    passed through untouched."""
    skips = quantized_conv_skips(spec, skip_final_convs, min_k2cin)
    out = {}
    for sm in spec.sub_models:
        sm_p = {}
        for key, entry in params[sm.name].items():
            if (sm.name, key) in skips or "kernel" not in entry:
                sm_p[key] = entry
            else:
                sm_p[key] = dict(entry, kernel=fake_quant_kernel(entry["kernel"]))
        out[sm.name] = sm_p
    return out
