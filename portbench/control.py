"""The check's control and faults at a cell's own size, on several seeds: a
run of the cell as the benchmark makes it (set-up, a window of
``--seconds``, what its check reads), after which the program's outputs in
what the check reads are replaced by a stand-in's, and the cell's own check
and limits (``run.verdict``) judge them. The benchmark's runs never run this.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] \\
        [--stand-ins <name> ...]

Stand-ins (``none``: the program's own outputs, a sound run):

  * ``lower_precision``: the reference one precision below the cell's
    (``reference/lowp.py``): the int4 lattice for ``int8_chain``, float8 for
    bf16 inference and training;
  * ``half_batch``: inference: the batch's second half answered with the
    first half's outputs; training: the reference trained on the first half
    of each batch, its mean taken over that half;
  * ``one_image``: inference: image 0 answered with image 1's outputs (a
    wrong index or a stale slot);
  * ``unchanged``: training: every step returns its state unchanged.

One JSON line a seed and stand-in: ``correct`` by the cell's limits, the
compared numbers beside their limits, and every number the check read.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAND_INS = {"infer": ("none", "lower_precision", "half_batch", "one_image"),
             "train": ("none", "lower_precision", "half_batch", "unchanged")}


def infer_stand_in(ctx, evidence, name):
    from portbench import judge
    from portbench.reference import detect as RD
    from portbench.reference import lowp

    if name == "none":
        return evidence
    e, cell = evidence, ctx.cell
    samples = []
    for i, out, host in e["samples"]:
        if name == "lower_precision":
            control = ({"lattice": lowp.INT4_LATTICE} if cell["tier"] == "int8_chain"
                       else {"rounding": lowp.Float8Rounding()})
            ops = judge.reference_ops(e["graph"], e["params"], e["state"], ctx.config, cell,
                                      e["calib"], ctx.device, **control)
            cfg = dict(ctx.config, anchors_table=judge.anchors(ctx.config))
            with torch.no_grad():
                boxes, conf, probs = judge.decoded(e["graph"], ops, cfg, e["inputs"](i))
                scores, classes = RD.scores_classes(conf, probs)
                nms = cell["nms"]
                sel, nv = RD.nms(boxes, scores, nms["max_boxes"], nms["iou_threshold"],
                                 nms["score_threshold"], nms["candidates"])
                sel, nv = sel.to(ctx.device), nv.to(ctx.device)
                out = (boxes, classes, scores, sel, nv)
                host = tuple(t.cpu() for t in RD.gather(*out))
        else:
            def plant(t):
                t = t.clone()
                if name == "one_image":
                    t[0] = t[1]
                else:
                    n = t.shape[0] // 2
                    t[n:2 * n] = t[:n]
                return t

            out, host = tuple(plant(t) for t in out), tuple(plant(t) for t in host)
        samples.append((i, out, host))
    return dict(e, samples=samples)


def train_stand_in(ctx, evidence, name):
    from portbench.judge import reference_train
    from portbench.modes import train as T
    from portbench.reference import lowp
    from portbench.reference import train as RT

    if name == "none":
        return evidence
    e, w = evidence, evidence["window"]
    if name == "unchanged":
        p0, s0 = RT.leaves(e["params"]), RT.leaves(e["state"])
        port = dict(e["port"], grad1={k: torch.zeros_like(v) for k, v in p0.items()},
                    state1=s0, params=p0, state=s0)
        b = w["before"]
        return dict(e, port=port, window=dict(w, port=dict(
            w["port"], grad1=b["mu"], state1=b["state"], params=b["params"], state=b["state"])))
    rounding = lowp.Float8Rounding() if name == "lower_precision" else None
    half = int(ctx.cell["batch"]) // 2

    def cut(batch):
        return (batch[0][:half], batch[1][:half]) if name == "half_batch" else batch

    def host(ref):
        return {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v)
                for k, v in ref.items()}

    cfg = dict(ctx.config, model_path=ctx.path(ctx.config["model"]))
    batches = [cut(e["feed"](j)) for j in range(T.CHECKED_STEPS)]
    port = host(reference_train(e["graph"], e["params"], e["state"], cfg, ctx.cell, batches,
                                rounding))
    params, state, _, _ = T.window_start(ctx, e)
    wport = host(reference_train(e["graph"], params, state, cfg, ctx.cell,
                                 [cut(e["feed"](w["index"]))], rounding, start=w["before"]))
    return dict(e, port=port, window=dict(w, port=wport))


def main(argv=None):
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
        os.path.abspath(__file__))]
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(prog="python3 portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--stand-ins", nargs="+", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import run as R

    cell = R.load_json("portbench", "workloads", f"{args.workload}.json")
    mode = importlib.import_module(f"portbench.modes.{cell['mode']}")
    stand = infer_stand_in if cell["mode"] == "infer" else train_stand_in
    names = args.stand_ins or STAND_INS[cell["mode"]]
    for seed in args.seeds:
        ctx = R.Context(args.workload, seed, args.seconds, 0, args.device, cell=cell)
        mode.run(ctx)
        for name in names:
            numbers = mode.check(ctx, stand(ctx, ctx.evidence, name))
            correct, check = R.verdict(cell["limits"], numbers)
            print(json.dumps({"workload": args.workload, "seed": seed, "stand_in": name,
                              "correct": correct, "check": check, "numbers": numbers}),
                  flush=True)
        del ctx
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
