"""The folded fp convs' tails' share of their bytes bound (K8,
``ops/cuda/bias_act.py``: bias add and activation in one pass).

The tails are the layer ranges ``L|<sub-model>|layer<i>|convolutional`` that
hold a kernel whose symbol contains ``bias_act``. A tail reads the conv's
output once and writes its own once, and reads the (C,) bias:
``batch · C·H·W · 2 · esize + C · esize`` bytes, from the layer's output
shape (``rec.table``) and the element size of the cell's tier (2 in bf16; 4
in fp32, and in the int8 tiers, whose fp parts run in f32), over 3.35 TB/s.
The time is the device time of those ``bias_act`` kernels in the traced
stretch. None where no such kernel ran (a program without K8)."""

from portbench.roofline import HBM_BYTES_PER_S

ESIZE = {"bf16": 2, "fp32": 4, "int8": 4, "int8_chain": 4}
KERNEL = "bias_act"


def tail_bytes(entry, batch: int, esize: int) -> int:
    c, h, w = entry["out"]
    return batch * c * h * w * 2 * esize + c * esize


def read(rec):
    t = rec.trace
    if t is None or not t.units:
        return None
    us = 0.0
    tails = set()
    for name, dur, layer, _ in t.attributed:
        if KERNEL in name and layer is not None and layer.endswith("|convolutional"):
            us += dur
            tails.add(layer)
    esize = ESIZE[rec.cell["tier"]]
    nbytes = 0
    for layer in tails:
        _, sm, key, _ = layer.split("|")
        nbytes += tail_bytes(rec.table[(sm, int(key[len("layer"):]))], rec.batch, esize)
    if us <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S * t.units / (us / 1e6)
