"""Per-layer MFU table of the inference forward on one card.

Counterpart of the JAX package's ``tools/mfu_table.py``, with its flags plus
``--device``:

    python -m yolov3_tpu_torch.tools.mfu_table [--quantize int8|int8_chain|bf16]
        [--model yolov3] [--batch 128] [--image_size 416] [--csv out.csv]
        [--device cpu]

Two halves, as in the JAX tool:

  * ``layer_shapes_and_macs``: the multiply-accumulates of every conv at the
    run's shapes, from the output shapes ``apply_model``'s ``out_observer``
    sees on the ``meta`` device (no compute) and the kernel shapes of the
    port's layouts (``kernel`` OIHW, ``kernel_q`` (cout, kh, kw, cin));
  * the device time of each layer, from a ``torch.profiler`` trace of two
    forwards (``ops/cuda/kernel_times.profile_window``): under a profiler
    every layer of ``models/network.py`` runs inside the range
    ``L|<sub-model>|<layer>|<kind>`` (the JAX package's ``named_scope``; a
    fused residual stage of ``int8_chain`` one range
    ``L|<sub-model>|layer<a>-layer<b>|resblock`` over the layers it
    replaces), and ``attribute`` gives each CUDA kernel to the innermost
    range around the op that launched it (the profiler links them by
    correlation id). Kernels outside every range are "unattributed
    (copies/misc)": the images' cast, the profiler's own pads are left out.

Per-layer MFU = 2 · MACs / (device time · peak), the peak of the tier from
NVIDIA's H100 SXM data sheet (int8 1,979 TOP/s, bf16 989 TFLOP/s, dense, at
a 700 W limit; the card's limit is printed beside it). The JSON line's
``e2e_mfu_pct`` divides the model's FLOPs by the whole forward's device time,
``attributed_mfu_pct`` by the attributed layers' time. A card run whose
trace holds no device record raises. On the CPU (``--device cpu``) the
table holds the MACs and no time: there is no device trace to read.
"""

from __future__ import annotations

import argparse
import collections
import csv
import json

import numpy as np
import torch

from ..device import resolve_device
from . import _measure as M

# H100 SXM published dense peaks (NVIDIA's data sheet), at the 700 W limit
PEAK = {"int8": 1979e12, "int8_chain": 1979e12, "bf16": 989e12}
PAD_KERNEL = "spin_kernel"  # kernel_times.profile_window's pads


def is_kernel(name: str) -> bool:
    """A device record of an op's ``kernels`` that is a kernel: not a pad of
    ``kernel_times.profile_window`` and not a layer range's span on the
    device (linked to the range itself, it covers the range's kernels)."""
    return PAD_KERNEL not in name and not name.startswith("L|")


def _meta_params(params):
    """The convs of ``params`` as fp kernels and biases on the ``meta`` device:
    ``kernel_q`` (cout, kh, kw, cin) read as OIHW, quantization and fusion
    entries dropped."""
    meta = {}
    for sm_name, sm_params in params.items():
        meta[sm_name] = {}
        for key, entry in sm_params.items():
            if "kernel_q" in entry:
                cout, kh, kw, cin = entry["kernel_q"].shape
            elif "kernel" in entry:
                cout, cin, kh, kw = entry["kernel"].shape
            else:
                continue
            meta[sm_name][key] = {"kernel": torch.empty((cout, cin, kh, kw), device="meta"),
                                  "bias": torch.empty((cout,), device="meta")}
    return meta


def layer_shapes_and_macs(spec, params, batch: int, image_size: int):
    """{(sm, layer): {"kind", "macs", "desc"}} of every layer at ``batch`` ×
    ``image_size``², from a forward on the ``meta`` device (shapes only);
    ``desc`` of a conv is ``"{kh}x{kw} {cin}->{cout} @{ho}x{wo}"``, as the
    JAX tool's."""
    from ..models import apply_model

    out_hw = {}

    def observer(sm_name, key, x):
        if x.dim() == 4:  # NCHW; a head's output is (B, g, g, 3, 5+nc)
            out_hw[(sm_name, key)] = (int(x.shape[2]), int(x.shape[3]))

    apply_model(spec, _meta_params(params), {},
                torch.empty((batch, image_size, image_size, 3), device="meta"),
                out_observer=observer)
    table = {}
    for sm in spec.sub_models:
        for i, layer in enumerate(sm.layers):
            key = (sm.name, f"layer{i}")
            entry = {"kind": layer.kind, "macs": 0, "desc": layer.kind}
            if layer.kind == "convolutional" and key in out_hw:
                p = params[sm.name][f"layer{i}"]
                if "kernel_q" in p:
                    cout, kh, kw, cin = p["kernel_q"].shape
                else:
                    cout, cin, kh, kw = p["kernel"].shape
                ho, wo = out_hw[key]
                entry["macs"] = batch * ho * wo * cout * kh * kw * cin
                entry["desc"] = f"{kh}x{kw} {cin}->{cout} @{ho}x{wo}"
            table[key] = entry
    return table


def range_layers(name: str):
    """A range name ``L|<sm>|<layer>|<kind>`` → (sm, layer key, [layer keys it
    covers]): one layer, or ``layer<a>-layer<b>`` of a fused stage, a to b."""
    _, sm, key, _ = name.split("|", 3)
    if "-" in key:
        a, b = (int(part[len("layer"):]) for part in key.split("-"))
        return sm, key, [f"layer{j}" for j in range(a, b + 1)]
    return sm, key, [key]


def attribute(events):
    """Device time of profiler events by layer range → (per_range, unattributed),
    two Counters of microseconds: ``per_range`` by range name
    (``L|...``), ``unattributed`` by kernel name. ``events`` are
    ``torch.profiler`` FunctionEvents (anything with ``name``, ``kernels``
    (name, device, duration µs) and ``cpu_parent``): each CPU event's
    kernels go to the innermost ``L|`` range among it and its parents, or
    to ``unattributed``. The pads of ``kernel_times.profile_window`` and the
    ranges' own device spans are left out (``is_kernel``)."""
    per_range, unattributed = collections.Counter(), collections.Counter()
    for ev in events:
        kernels = [k for k in getattr(ev, "kernels", ()) if is_kernel(k.name)]
        if not kernels:
            continue
        scope, node = None, ev
        while node is not None:
            if node.name.startswith("L|"):
                scope = node.name
                break
            node = node.cpu_parent
        for k in kernels:
            if scope is None:
                unattributed[k.name] += k.duration
            else:
                per_range[scope] += k.duration
    return per_range, unattributed


def table_rows(per_range, macs, steps: int, peak: float):
    """Rows of the table (ms a forward, GFLOP, MFU %), slowest first."""
    rows = []
    for name, us in per_range.items():
        sm, key, keys = range_layers(name)
        t = us / 1e6 / steps
        flops = 2 * sum(macs.get((sm, k), {"macs": 0})["macs"] for k in keys)
        desc = (macs.get((sm, key), {"desc": "?"})["desc"] if len(keys) == 1
                else f"K4 stage, {len(keys) // 3} blocks")
        rows.append({"layer": f"{sm}/{key}", "desc": desc, "ms": t * 1e3,
                     "gflops": flops / 1e9,
                     "mfu_pct": 100.0 * flops / (t * peak) if t > 0 and flops else 0.0})
    rows.sort(key=lambda r: -r["ms"])
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.mfu_table")
    ap.add_argument("--quantize", default="int8", choices=["int8", "int8_chain", "bf16"])
    ap.add_argument("--model", default="yolov3")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image_size", type=int, default=416)
    ap.add_argument("--s2d", action="store_true", default=True)
    ap.add_argument("--no_s2d", dest="s2d", action="store_false")
    ap.add_argument("--csv", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.s2d and args.quantize != "bf16":
        raise ValueError("--no_s2d: the port's int8 tiers always take the bit-exact "
                         "space-to-depth stem (make_predictor); there is no tier without it")
    dev = resolve_device(args.device)
    module = M.build_tier(f"config/models/{args.model}/model.yaml", 80, args.quantize,
                          args.image_size, dev)
    params = module.tree("params")
    macs = layer_shapes_and_macs(module.spec, params, args.batch, args.image_size)
    model_flops = 2 * sum(m["macs"] for m in macs.values())
    x = torch.from_numpy(np.random.RandomState(0).rand(
        args.batch, args.image_size, args.image_size, 3).astype(np.float32)).to(dev)
    peak = PEAK[args.quantize]
    device = M.device_record(dev)
    steps = 2

    def fwd():
        from ..models import apply_model

        outs = apply_model(module.spec, params, {}, M.tier_inputs(module, x))
        return sum(o.float().sum() for o in outs)

    with torch.inference_mode():
        checksum = float(fwd())  # warm-up: cuDNN plans, kernel builds
        if not np.isfinite(checksum):
            raise AssertionError(f"mfu_table: non-finite forward checksum {checksum}")
        if dev.type == "cuda":
            from ..ops.cuda import kernel_times

            prof, _, records = kernel_times.profile_window(lambda: [fwd() for _ in range(steps)])
            if not records:
                raise RuntimeError("mfu_table: the profiler trace holds no device record")
            per_range, unattributed = attribute(prof.events())
            linked = sum(per_range.values()) + sum(unattributed.values())
            unlinked = sum(us for _, _, us in records) - linked
            if unlinked > 0:
                unattributed["(kernels linked to no op)"] += unlinked
        else:
            per_range, unattributed = collections.Counter(), collections.Counter()

    rows = table_rows(per_range, macs, steps, peak)
    print(f"device: {M.device_text(device)}; peak {args.quantize} {peak / 1e12:.0f} T ops/s "
          "(H100 SXM data sheet, dense, at 700 W)")
    hdr = f"{'layer':34s} {'conv':22s} {'ms':>7s} {'GFLOP':>9s} {'MFU%':>6s}"
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['layer']:34s} {r['desc']:22s} {r['ms']:7.3f} "
              f"{r['gflops']:9.1f} {r['mfu_pct']:6.1f}")
    print("-" * len(hdr))
    if dev.type != "cuda":
        print(f"{'model (no device trace on the CPU)':34s} {'':22s} {'':>7s} "
              f"{model_flops / 1e9:9.1f}")
        result = {"quantize": args.quantize, "batch": args.batch, "device_ms_fwd": None,
                  "img_per_sec_fwd": None, "model_flops_g": round(model_flops / 1e9, 1),
                  "attributed_mfu_pct": None, "e2e_mfu_pct": None, "device": device}
        print(json.dumps(result), flush=True)
        return dict(result, rows=rows, unattributed={})
    total_t = sum(r["ms"] for r in rows)
    total_f = sum(r["gflops"] for r in rows)
    other_t = sum(unattributed.values()) / steps / 1e3
    mfu = 100.0 * total_f * 1e9 / (total_t / 1e3 * peak)
    print(f"{'TOTAL attributed':34s} {'':22s} {total_t:7.2f} {total_f:9.1f} {mfu:6.1f}")
    print(f"{'unattributed (copies/misc)':34s} {'':22s} {other_t:7.2f}")
    for k, v in unattributed.most_common(6):
        print(f"   {k[:31]:31s} {'':22s} {v / steps / 1e3:7.2f}")
    full = total_t + other_t
    result = {"quantize": args.quantize, "batch": args.batch,
              "device_ms_fwd": round(full, 2),
              "img_per_sec_fwd": round(args.batch / (full / 1e3), 1),
              "model_flops_g": round(total_f, 1),
              "attributed_mfu_pct": round(mfu, 1),
              "e2e_mfu_pct": round(100.0 * total_f * 1e9 / (full / 1e3 * peak), 1),
              "device": device}
    print(json.dumps(result), flush=True)
    if args.csv:
        with open(args.csv, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"csv -> {args.csv}")
    return dict(result, rows=rows, unattributed={k: v / steps / 1e3
                                                 for k, v in unattributed.items()},
                model_flops_all_convs_g=model_flops / 1e9)


if __name__ == "__main__":
    main()
