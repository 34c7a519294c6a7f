"""Training BatchNorm's statistics kernels' share of their bytes bound (K5,
``ops/cuda/bn_stats.py``).

Per step, every BatchNorm of the model takes its statistics once forward
and their gradient once backward. The bound counts, from the layers'
shapes at the step's batch and the precision's element size, the input
read once and the (4, C) f32 statistics written (forward), and the input
read, its gradient written and three (C,) vectors read (backward), over
3.35 TB/s. The time is the device time of K5's kernels in the traced
stretch, found by their symbols (``bn_moments_*_kernel``, ``bn_dx_kernel``)."""

from portbench.roofline import HBM_BYTES_PER_S, bn_stats_backward_bytes, bn_stats_forward_bytes

ESIZE = {"bf16": 2, "fp32": 4}
K5 = ("bn_moments_", "bn_dx_kernel")


def read(rec):
    t = rec.trace
    if t is None or not t.units:
        return None
    us = sum(stop - start for start, stop, name in t.kernels if any(k in name for k in K5))
    esize = ESIZE[rec.cell["precision"]]
    nbytes = 0
    for e in rec.table.values():
        if e["kind"] == "convolutional" and e["bn"]:
            elems = rec.batch * e["out"][0] * e["out"][1] * e["out"][2]
            nbytes += (bn_stats_forward_bytes(elems, esize, e["cout"])
                       + bn_stats_backward_bytes(elems, esize, e["cout"]))
    if us <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S * t.units / (us / 1e6)
