"""Functional model interpreter: (spec, params, state, images) → head outputs.

Counterpart of ``yolov3_tpu/models/network.py``. Parameters and BatchNorm
running statistics are plain nested dicts of tensors with the JAX package's
keys, so checkpoints move across unchanged (``io/checkpoint.py``):

    params[sub_model][f"layer{i}"] = {"kernel" (OIHW), ("bias" | "bn": {gamma, beta})}
    state [sub_model][f"layer{i}"] = {"mean", "var"}          (BN layers only)

fp activations flow as logical NCHW inside; the public boundary keeps the
JAX layout: ``images`` are NHWC and each head output is ``(B, g, g, 3,
5+nc)`` (the head is permuted to NHWC before the reshape, so channel
``a·(5+nc)+f`` maps exactly as in JAX). A conv applies BN iff its param dict
holds a "bn" entry, which makes ``fold_batch_norm`` a pure params→params
transform.

The int8 tiers (``ops/quantize.py``): a conv whose entry holds ``kernel_q``
takes the int8 path (``layers.conv2d_int8``), whose kernels want channels
innermost. Quantized activations travel as ``layers.QAct`` with a contiguous
NHWC ``q``; fp tensors stay logical NCHW but, coming from the NHWC image or
from an int8 conv, are channels-last in memory, so the NHWC view a quantized
conv asks for is free and nothing bounces between layouts per layer.

In the ``int8_chain`` tier a Darknet residual stage (1×1 squeeze, 3×3
expand, shortcut; repeated) whose shape the fused residual-block kernel
takes runs through it (``ops/cuda/resblock.py::fused_stage``, K4) with one
layout change in and one out, instead of K3 → K6 → ``add_requant`` a block.
It computes the same bits. A forward with an observer runs every layer
unfused, so the observer sees them all. ``pack_fused_stages`` computes the
fused blocks' constant kernel arguments once, ahead of the forwards.

Under a profiler every layer runs inside a range named as the JAX
package's ``named_scope``, ``L|<sub-model>|<layer>|<kind>``, and a fused
stage inside one range over the layers it replaces,
``L|<sub-model>|layer<a>-layer<b>|resblock`` (``tools/mfu_table.py`` reads
them); with no profiler running no range is entered.

One interpreter serves the unsharded forward and the spatial split of
image rows (``parallel/spatial.py``): every activation is a
``spatial.Bands``, the unsharded one a single band, and every layer runs
band by band, a windowed one on its band's rows with their halo rows.
"""

from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from ..ops.cuda import resblock
from ..parallel import spatial as sp
from ..utils.profiling import profiler_range
from . import layers as L
from .spec import LayerSpec, ModelSpec, SubModelSpec


# The profiler range of one layer, ``L|<sub-model>|<layer>|<kind>`` as the
# JAX package's ``named_scope`` (``tools/mfu_table.py`` attributes device
# time to layers by it): the profiler half of a span, entered only while a
# profiler runs and recording nothing on the host. With none, the shared
# null context, so serving, ``torch.export`` and a train step run the same
# ops as without it.
_layer_range = profiler_range


def _deq(x, fp_dtype):
    """QAct → fp (logical NCHW over the NHWC memory); fp tensors pass through."""
    if isinstance(x, L.QAct):
        return L.dequantize(x, fp_dtype).permute(0, 3, 1, 2)
    return x


def _route_sources(layer: LayerSpec, inputs_entry, layer_outs, fp_dtype):
    """Reference core/parse_model.py:102-140 route semantics, band by band
    (the sources' bands agree: rows owned on the coarsest grid, see
    ``parallel/spatial.py``); any number of sources concatenate in their
    order (Darknet's route, e.g. YOLOv4's four-way SPP join). Quantized
    sources of a concat are dequantized: int8 tensors with different scales
    have no single-scale concatenation."""
    source = dict(layer["source"])
    selected = []
    if "layers" in source:
        selected.extend(layer_outs[int(i)] for i in source["layers"])
    if "inputs" in source:
        if isinstance(inputs_entry, (list, tuple)):
            selected.extend(inputs_entry[int(i)] for i in source["inputs"])
        else:
            selected.append(inputs_entry)
    if len(selected) == 1:
        return selected[0]
    if not selected:
        raise ValueError("Invalid route: no sources")
    a = selected[0]
    for b in selected[1:]:
        if a.starts != b.starts:
            raise ValueError(f"spatial: a route joins bands {a.starts} and {b.starts}")
    return a.with_parts([None if parts[0] is None else torch.cat(
        [_deq(p, fp_dtype) for p in parts], dim=1)
        for parts in zip(*(src.parts for src in selected))])


def _pool_int8(q, size_xy, stride_xy, padding, pads=None):
    """Max-pool of an NHWC int8 tensor. ``max_pool2d`` has no int8 kernel on
    CUDA, so the values go through float32 and back, which is exact."""
    y = L.max_pool(q.permute(0, 3, 1, 2).to(torch.float32), size_xy, stride_xy, padding, pads)
    return y.permute(0, 2, 3, 1).to(torch.int8).contiguous()


def _fusable_stages(sm: SubModelSpec, sm_params):
    """{first layer: block starts} of the residual stages
    (``resblock.residual_blocks``) that may run fused: every block's two
    convs quantized with an output scale and its shortcut with one, a shape
    the kernel takes (``resblock.supports``), and no layer or output outside
    the stage's own shortcuts reading a layer the fused stage does not
    materialize (all but its last)."""
    n = len(sm.layers)
    reads = [(n, j % n) for j in sm.outputs_layers]
    for i, layer in enumerate(sm.layers):
        if layer.kind == "shortcut":
            reads.append((i, i + int(layer["from"])))
        elif layer.kind == "route":
            reads.extend((i, i + int(j) if int(j) < 0 else int(j))
                         for j in dict(layer["source"]).get("layers", ()))
    fusable = {}
    for starts in resblock.residual_blocks(sm):
        first, last = starts[0], starts[-1] + 2
        own = {i + 2 for i in starts}
        quantized = all("out_scale" in sm_params.get(f"layer{i + d}", {})
                        and (d == 2 or "kernel_q" in sm_params[f"layer{i + d}"])
                        for i in starts for d in range(3))
        if not quantized or any(first <= j < last and r not in own for r, j in reads):
            continue
        squeeze = sm_params[f"layer{first}"]["kernel_q"]   # (Cm, 1, 1, C)
        if resblock.supports(squeeze.shape[3], squeeze.shape[0]):
            fusable[first] = starts
    return fusable


def pack_fused_stages(spec: ModelSpec, params):
    """Chain-mode quantized ``params`` with the constant kernel arguments of
    every residual block that the forward runs through K4
    (``resblock.block_constants``: the repacked weights and the scalars of
    the block's params) computed once, under the block's squeeze entry as
    ``"fused"``. The ``int8_chain`` predictor packs its params when it is
    built, so no forward repacks a weight and nothing is cached inside one.
    Returns a new tree; ``params`` is left as it is."""
    packed = dict(params)
    for sm in spec.sub_models:
        sm_params = dict(params[sm.name])
        for starts in _fusable_stages(sm, sm_params).values():
            for i in starts:
                squeeze = sm_params[f"layer{i}"]
                sm_params[f"layer{i}"] = dict(squeeze, fused=resblock.block_constants(
                    squeeze, sm_params[f"layer{i + 1}"], sm_params[f"layer{i + 2}"]))
        packed[sm.name] = sm_params
    return packed


def _params_on(sm_params, devices):
    """``on(device)`` → the sub-model's params on a band's device (as they
    are when every band shares one device)."""
    if len(set(devices)) == 1:
        return lambda dev: sm_params
    return functools.lru_cache(maxsize=None)(lambda dev: to_device(sm_params, dev))


def _conv_tail(x, on, key, bn_state, bn_train, phases, stats_subsample, activation,
               bn_group=None):
    """What follows an fp conv, band by band: BatchNorm (or the bias), then
    the layer's ``activation`` (``spec.ACTIVATIONS``) → (y, the BN layer's
    new state or None). Training-mode BatchNorm over more than one band
    normalizes every band with the statistics of all of them
    (``spatial.band_moments``); ``layers.batch_norm`` applies a LeakyReLU
    after it (through K7 in training on the card). Mish follows the bias
    (or an inference BatchNorm) as ``layers.mish``."""
    leaky = activation == "leaky"
    moments = None
    if "bn" in on(x.devices[0])[key] and bn_train and len(x.parts) > 1:
        moments = sp.band_moments(x, phases, stats_subsample, bn_group)
    states = []

    def tail(j, part):
        dev = x.devices[j]
        p = on(dev)[key]
        if "bn" in p:
            part, st = L.batch_norm(
                part, p["bn"], None if bn_state is None else to_device(bn_state, dev),
                bn_train, phases=phases, stats_subsample=stats_subsample, group=bn_group,
                moments=None if moments is None else tuple(m.to(dev) for m in moments),
                leaky=leaky)
            states.append(st)
            return L.mish(part) if activation == "mish" else part
        if "bias" in p:
            part = part + p["bias"].to(part.dtype).view(1, -1, 1, 1)
        return L.leaky_relu(part) if leaky else L.mish(part) if activation == "mish" else part

    x = x.map(tail)
    return x, (states[0] if states else None)


def _apply_sub_model(sm: SubModelSpec, sm_params, sm_state, inputs_entry,
                     nclasses: int, fp_dtype, conv_observer=None, out_observer=None,
                     bn_train: bool = False, new_state=None, conv_input_transform=None,
                     bn_stats_subsample: int = 1, remat_tail: bool = False, bn_group=None):
    """Run one sub-model's layer list over the bands of its input (a
    ``spatial.Bands``, or a list of them; the unsharded forward is one
    band); returns its selected outputs, as ``Bands``.

    Every windowed layer (conv, max-pool) runs per band on the band's rows
    with their halo rows (``spatial.window``); 1×1 convs, shortcuts,
    upsamples, routes and heads per band as they are; a fused residual stage
    through K4 per band (``spatial.fused_stage_bands``). Each band uses the
    params on its own device.

    ``bn_train`` runs every BatchNorm on the batch's statistics (from a
    ``bn_stats_subsample`` spatial subsample, synced over ``bn_group``, see
    ``layers.batch_norm``; over every band, see ``_conv_tail``);
    each BN layer's new running statistics go into the dict ``new_state``
    (when one is given) under the layer's key.

    ``conv_input_transform(sm_name, layer_key, x)`` replaces the input of
    every fp conv (one without ``kernel_q``: a quantized conv consumes its
    QAct as it is) — the hook of activation QAT; over more than one band
    ``x`` is the list of the non-empty bands and it returns one.

    ``remat_tail`` checkpoints each BN conv's tail (``_conv_tail``): the
    conv's output is kept, the tail recomputes in the backward pass.

    ``conv_observer(sm_name, layer_key, x)`` is called with each conv's
    input and ``out_observer(sm_name, layer_key, x)`` with each layer's
    output, both as fp tensors — used by int8 calibration, which runs
    unsharded (one band).

    Activations may flow as ``layers.QAct`` between quantized convs: a conv
    whose entry carries ``out_scale`` emits one; a shortcut of two QActs
    whose entry carries ``out_scale`` is a dequant-add-requant; upsample and
    maxpool pass int8 through with the scale (both are monotone and keep the
    lattice); routes, fp convs and ``yolo`` dequantize.
    """
    x = inputs_entry if not isinstance(inputs_entry, (list, tuple)) else inputs_entry[0]
    observed = conv_observer is not None or out_observer is not None
    if observed and len(x.parts) > 1:
        raise ValueError("the observers (int8 calibration) run unsharded, on one band")
    on = _params_on(sm_params, x.devices)
    fusable = {} if observed else _fusable_stages(sm, sm_params)
    layer_outs = []
    for i, layer in enumerate(sm.layers):
        if i < len(layer_outs):
            continue  # inside a stage that ran fused
        key = f"layer{i}"
        starts = fusable.get(i)
        if starts and all(isinstance(p, L.QAct) for p in x.parts if p is not None):
            last = starts[-1] + 2
            with _layer_range(f"L|{sm.name}|{key}-layer{last}|resblock"):
                x = sp.fused_stage_bands(x, on, starts)
            layer_outs.extend([None] * (last - i) + [x])
            continue
        with _layer_range(f"L|{sm.name}|{key}|{layer.kind}"):
            if layer.kind == "convolutional":
                p = sm_params[key]
                if conv_observer is not None:
                    conv_observer(sm.name, key, _deq(x.parts[0], fp_dtype))
                if conv_input_transform is not None and "kernel_q" not in p:
                    fp = [_deq(part, fp_dtype) for part in x.parts if part is not None]
                    done = conv_input_transform(sm.name, key, fp[0] if len(fp) == 1 else fp)
                    done = iter([done] if len(fp) == 1 else done)
                    x = x.with_parts([None if part is None else next(done) for part in x.parts])
                stride, pad = layer["stride"], layer.get("pad", 1)
                explicit = layer.get("explicit_pad")
                activation = layer.get("activation", "linear")
                leaky = activation == "leaky"
                if "kernel_q" in p:
                    k = p["kernel_q"].shape[1]

                    def conv_q(dev, xb, rows, key=key, stride=stride, pad=pad, explicit=explicit,
                               leaky=leaky):
                        fp_in = not isinstance(xb, L.QAct)
                        if fp_in:
                            xb = xb.permute(0, 2, 3, 1)  # NHWC; a view when channels-last
                        y = L.conv2d_int8(xb, on(dev)[key], stride, pad, leaky=leaky,
                                          fp_dtype=fp_dtype, explicit_pad=explicit, rows=rows)
                        return y if isinstance(y, L.QAct) else y.permute(0, 3, 1, 2)

                    x = sp.window(x, k, stride, L.conv_padding(k, stride, pad, explicit)[0], conv_q)
                else:
                    # s2d_phase layers (ops/s2d.py::s2d_stem_train) carry the
                    # ORIGINAL 3×3 kernels; the phase kernel is built in the graph
                    s2d = layer.get("s2d_phase")
                    kernel = (L.s2d_phase_kernel_conv0(p["kernel"]) if s2d == "conv0"
                              else L.s2d_phase_kernel_conv1(p["kernel"]) if s2d == "conv1"
                              else p["kernel"])
                    k = kernel.shape[2]
                    x = sp.window(x, k, stride, L.conv_padding(k, stride, pad, explicit)[0],
                                  lambda dev, xb, rows, kernel=kernel, stride=stride, pad=pad,
                                  explicit=explicit: L.conv2d(
                                      _deq(xb, fp_dtype), kernel.to(dev), stride, pad,
                                      explicit_pad=explicit, rows=rows))
                    tail = functools.partial(
                        _conv_tail, on=on, key=key, bn_state=sm_state.get(key), bn_train=bn_train,
                        phases=4 if s2d == "conv0" else 1, stats_subsample=bn_stats_subsample,
                        activation=activation, bn_group=bn_group)
                    if remat_tail and "bn" in p:
                        x, layer_state = torch.utils.checkpoint.checkpoint(
                            tail, x, use_reentrant=False, preserve_rng_state=False)
                    else:
                        x, layer_state = tail(x)
                    if layer_state is not None and new_state is not None:
                        new_state[key] = layer_state
            elif layer.kind == "shortcut":
                other = layer_outs[layer["from"]]
                quantized = "out_scale" in sm_params.get(key, {})

                def add(j, part, other=other, key=key, quantized=quantized):
                    o = other.parts[j]
                    if quantized and isinstance(part, L.QAct) and isinstance(o, L.QAct):
                        return L.add_requant(o, part, on(x.devices[j])[key]["out_scale"])
                    return _deq(o, fp_dtype) + _deq(part, fp_dtype)

                x = x.map(add)
            elif layer.kind == "route":
                x = _route_sources(layer, inputs_entry, layer_outs, fp_dtype)
            elif layer.kind == "upsample":
                s = layer["stride"]
                x = x.map(lambda j, part, s=s: L.QAct(
                    part.q.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2), part.scale)
                    if isinstance(part, L.QAct) else L.upsample_nearest(part, s))
            elif layer.kind == "maxpool":
                size, stride, padding = (list(layer["size_xy"]), list(layer["stride_xy"]),
                                         layer["padding"])
                part = next(p for p in x.parts if p is not None)
                width = part.q.shape[2] if isinstance(part, L.QAct) else part.shape[3]
                if padding.lower() == "same":
                    pads = L._pool_same_pads((x.height, width), size, stride)
                elif size[0] == stride[0] or len(x.parts) == 1:
                    pads = ((0, 0), (0, 0))
                else:
                    raise ValueError(f"spatial: a 'valid' max-pool of {size} at stride {stride} "
                                     "does not split over bands")

                def pool(dev, xb, rows, size=size, stride=stride, padding=padding, pads=pads):
                    band_pads = (rows, pads[1])
                    if isinstance(xb, L.QAct):
                        return L.QAct(_pool_int8(xb.q, size, stride, padding, band_pads), xb.scale)
                    return L.max_pool(xb, size, stride, padding, band_pads)

                x = sp.window(x, size[0], stride[0], pads[0], pool)
            elif layer.kind == "yolo":
                # raw logits, no activation (reference parse_model.py:209-211);
                # NHWC before the reshape keeps JAX's channel→(anchor, field) map
                def head(j, part):
                    part = _deq(part, fp_dtype)
                    b, c, h, w = part.shape
                    return part.permute(0, 2, 3, 1).reshape(b, h, w, 3, 5 + nclasses)

                x = x.map(head, nhwc=True)
            else:
                raise ValueError(f"unknown layer kind {layer.kind}")
        if out_observer is not None:
            out_observer(sm.name, key, _deq(x.parts[0], fp_dtype))
        layer_outs.append(x)
    return [layer_outs[i] for i in sm.outputs_layers]


def apply_model(spec: ModelSpec, params, state, images, conv_observer=None,
                out_observer=None, train: bool = False, bn_frozen: tuple = (),
                remat=False, conv_input_transform=None, bn_stats_subsample: int = 1,
                bn_group=None, devices=None):
    """Forward pass. ``images``: (B, H, W, 3) float tensor.

    Returns the list of head outputs ``(B, g, g, 3, 5+nc)`` in the order of
    the sub-models whose name contains ``spec.output_stage`` (13-grid head
    first for yolov3), in ``images.dtype``; with ``train=True`` returns
    ``(outputs, new_state)``, the BatchNorm running statistics after this
    batch, as the JAX package's ``apply_model`` does. The observers see every
    conv's input and every layer's output (int8 calibration).

    ``devices``: the band devices of a spatial split (``parallel/spatial.py``):
    each image's rows split into ``len(devices)`` bands, once, on the
    devices; ``images`` may also arrive as their ``spatial.Bands``
    (``mesh.image_sharding``). ``params`` / ``state`` live on the first band's
    device, each band uses them moved to its own, and the heads come back
    whole on the first band's device. None: one band, the unsharded forward.

    ``bn_frozen``: substrings of sub-model names whose BN layers keep their
    running statistics during training (transfer learning's
    batch_norm_freeze_list). ``remat=True`` checkpoints each sub-model: its
    activations are recomputed in the backward pass instead of kept; the new
    BN state is the first forward's, the recomputation's is dropped.
    ``remat="conv"`` keeps every convolution's output and recomputes what
    follows it (BN, LeakyReLU) in the backward pass, one layer at a time: a
    checkpoint around each conv's tail, whose input is the conv output. (A
    selective-checkpoint policy over a whole sub-model recomputes the
    sub-model at once; on an H100 at YOLOv3-416, B=16, it saved no memory.)
    The statistics kernel (K5) runs its forward again in the recomputation.

    ``conv_input_transform``: see ``_apply_sub_model`` (activation QAT).
    ``bn_stats_subsample``: the stride of the spatial subsample training-mode
    BatchNorm takes its statistics from (1: every pixel).
    ``bn_group``: a ``torch.distributed`` process group over which
    training-mode BatchNorm takes the global batch's statistics (sync-BN, as
    the JAX package's SPMD step does); frozen layers do not sync.
    """
    if isinstance(images, sp.Bands):
        x = images
    elif devices is not None and len(devices) > 1:
        x = sp.split_rows(images, devices, sp.total_stride(spec, images.shape[1]))
    else:
        x = sp.whole(images, nhwc=True)
    fp_dtype = next(p for p in x.parts if p is not None).dtype
    x = x.map(lambda j, part: part.permute(0, 3, 1, 2))
    produced = {}
    new_state = {}
    for sm in spec.sub_models:
        if sm.inputs is None:
            inputs_entry = x
        else:
            srcs = [produced[name][entry_index] for name, entry_index in sm.inputs]
            inputs_entry = srcs[0] if len(srcs) == 1 else srcs
        bn_train = train and not any(s and s in sm.name for s in bn_frozen)

        def run(sm_params, sm_state, inputs, _sm=sm, _bn=bn_train):
            sm_new_state = {}
            outs = _apply_sub_model(_sm, sm_params, sm_state, inputs, spec.nclasses,
                                    fp_dtype, conv_observer, out_observer,
                                    bn_train=_bn, new_state=sm_new_state,
                                    conv_input_transform=conv_input_transform,
                                    bn_stats_subsample=bn_stats_subsample,
                                    remat_tail=train and remat == "conv", bn_group=bn_group)
            return outs, sm_new_state

        if remat and remat != "conv" and train:
            outs, sm_new_state = torch.utils.checkpoint.checkpoint(
                run, params[sm.name], state.get(sm.name, {}), inputs_entry,
                use_reentrant=False, preserve_rng_state=False)
        else:
            outs, sm_new_state = run(params[sm.name], state.get(sm.name, {}), inputs_entry)
        produced[sm.name] = outs
        if sm_new_state:
            new_state[sm.name] = sm_new_state
    outputs = [sp.gather_rows(out) for sm in spec.output_sub_models for out in produced[sm.name]]
    return (outputs, new_state) if train else outputs


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _infer_channels(spec: ModelSpec):
    """Static channel-count inference per layer, for param shapes."""
    produced = {}
    per_layer = {}
    for sm in spec.sub_models:
        if sm.inputs is None:
            inputs_c = 3
        else:
            srcs = [produced[name][entry_index] for name, entry_index in sm.inputs]
            inputs_c = srcs[0] if len(srcs) == 1 else srcs
        c = inputs_c if not isinstance(inputs_c, list) else inputs_c[0]
        outs_c = []
        for i, layer in enumerate(sm.layers):
            if layer.kind == "convolutional":
                per_layer[(sm.name, i)] = (c, layer["filters"])
                c = layer["filters"]
            elif layer.kind == "route":
                source = dict(layer["source"])
                sel = []
                if "layers" in source:
                    sel.extend(outs_c[int(j)] for j in source["layers"])
                if "inputs" in source:
                    if isinstance(inputs_c, list):
                        sel.extend(inputs_c[int(j)] for j in source["inputs"])
                    else:
                        sel.append(inputs_c)
                c = sum(sel) if len(sel) > 1 else sel[0]
            outs_c.append(c)
        produced[sm.name] = [outs_c[i] for i in sm.outputs_layers]
    return per_layer


def init_model(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32):
    """(params, state) with Keras-default initializers: glorot-uniform kernels
    drawn from ``generator`` (a CPU ``torch.Generator``), BN gamma 1 / beta 0,
    running mean 0 / var 1, bias 0. Tensors live on the CPU; move them with
    ``to_device``."""
    per_layer = _infer_channels(spec)
    params, state = {}, {}
    for sm in spec.sub_models:
        sm_params, sm_state = {}, {}
        for i, layer in enumerate(sm.layers):
            if layer.kind != "convolutional":
                continue
            cin, cout = per_layer[(sm.name, i)]
            k = layer["size"]
            entry = {"kernel": L.glorot_uniform(generator, (cout, cin, k, k), dtype)}
            if layer["batch_normalize"]:
                entry["bn"] = {"gamma": torch.ones(cout, dtype=dtype),
                               "beta": torch.zeros(cout, dtype=dtype)}
                sm_state[f"layer{i}"] = {"mean": torch.zeros(cout), "var": torch.ones(cout)}
            else:
                entry["bias"] = torch.zeros(cout, dtype=dtype)
            sm_params[f"layer{i}"] = entry
        params[sm.name] = sm_params
        if sm_state:
            state[sm.name] = sm_state
    return params, state


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


def to_device(tree, device, dtype=None):
    """Move (and optionally cast) every tensor of a params/state tree."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype or tree.dtype)


def l2_regularization(params, decay: float):
    """Keras l2(decay) on every conv kernel, frozen or not: decay · Σ w², in f32."""
    total = 0.0
    for sm_params in params.values():
        for entry in sm_params.values():
            k = entry["kernel"].float()
            total = total + torch.sum(k * k)
    return decay * total


def fold_batch_norm(params, state, eps: float = L.BN_EPS):
    """Fold BN into conv kernel+bias for inference (pure params transform).

    y = gamma*(conv(x) - mean)/sqrt(var+eps) + beta
      = conv(x, kernel*s) + (beta - mean*s),  s = gamma/sqrt(var+eps)
    """
    folded = {}
    for sm_name, sm_params in params.items():
        sm_folded = {}
        for key, entry in sm_params.items():
            if "bn" in entry:
                bn = entry["bn"]
                st = state[sm_name][key]
                s = bn["gamma"] / torch.sqrt(st["var"] + eps)
                sm_folded[key] = {
                    "kernel": entry["kernel"] * s.view(-1, 1, 1, 1),
                    "bias": bn["beta"] - st["mean"] * s,
                }
            else:
                sm_folded[key] = dict(entry)
        folded[sm_name] = sm_folded
    return folded


def head_grid_sizes(spec: ModelSpec, image_size: int):
    """Grid size of each head output at a given input resolution, from the
    actual graph run on meta tensors (shapes only, no FLOPs)."""
    params = {}
    for (sm_name, i), (cin, cout) in _infer_channels(spec).items():
        k = _spec_layer(spec, sm_name, i)["size"]
        params.setdefault(sm_name, {})[f"layer{i}"] = {
            "kernel": torch.empty((cout, cin, k, k), device="meta"),
            "bias": torch.empty((cout,), device="meta")}
    for sm in spec.sub_models:
        params.setdefault(sm.name, {})
    images = torch.empty((1, image_size, image_size, 3), device="meta")
    return tuple(o.shape[1] for o in apply_model(spec, params, {}, images))


def _spec_layer(spec: ModelSpec, sm_name: str, i: int) -> LayerSpec:
    return next(sm for sm in spec.sub_models if sm.name == sm_name).layers[i]


def param_count(params) -> int:
    total = 0
    for sm_params in params.values():
        for entry in sm_params.values():
            total += entry["kernel"].numel()
            total += entry["bias"].numel() if "bias" in entry else 0
            if "bn" in entry:
                total += sum(v.numel() for v in entry["bn"].values())
    return total
