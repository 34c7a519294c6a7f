"""The residual stages' share of their roofline (K4, ``ops/cuda/resblock.py``).

The least time the stages the trace shows need, over the device time of the
kernels attributed to their ranges ``L|<sub-model>|layer<a>-layer<b>|resblock``.
Each block of a stage is a 1×1 squeeze, a 3×3 expand and the add-requant of
the shortcut, counted from the blocks' shapes whatever implements them: its
operations are 2 · (the two convs' MACs); its bytes the block's int8 input
read once, its int8 output written once, both kernels once and their f32
scales and biases. A block needs the larger of operations over 1,979 TOP/s
and bytes over 3.35 TB/s."""

from portbench.roofline import HBM_BYTES_PER_S, PEAK_OPS_PER_S


def _stage_seconds(table, sm, first, last, batch):
    total = 0.0
    for j in range(first, last + 1, 3):
        sq, ex, add = table[(sm, j)], table[(sm, j + 1)], table[(sm, j + 2)]
        if (sq["kind"], ex["kind"], add["kind"]) != ("convolutional", "convolutional", "shortcut"):
            return None
        elems = sq["in"][0] * sq["in"][1] * sq["in"][2]
        weights = sum(e["cout"] * e["cin"] * e["k"] ** 2 for e in (sq, ex))
        nbytes = batch * 2 * elems + weights + 8 * (sq["cout"] + ex["cout"]) + 12
        ops = 2.0 * batch * (sq["macs"] + ex["macs"])
        total += max(ops / PEAK_OPS_PER_S["int8"], nbytes / HBM_BYTES_PER_S)
    return total


def read(rec):
    t = rec.trace
    if t is None or not t.units:
        return None
    us, need = 0.0, 0.0
    stages = set()
    for _, dur, layer, _ in t.attributed:
        if layer is not None and layer.endswith("|resblock"):
            us += dur
            stages.add(layer)
    for name in stages:
        _, sm, span, _ = name.split("|")
        a, b = (int(p[len("layer"):]) for p in span.split("-"))
        seconds = _stage_seconds(rec.table, sm, a, b, rec.batch)
        if seconds is None:
            return None
        need += seconds
    if us <= 0 or need <= 0:
        return None
    return 100.0 * need * t.units / (us / 1e6)
