"""Device milliseconds a batch of the kernels whose symbol contains
``mish``: ATen's Mish kernel behind the port's Mish tails (``F.mish``), or
a fused tail that keeps ``mish`` in its name. None where no such kernel ran
(a model without Mish, a program without it)."""


def read(rec):
    t = rec.trace
    if t is None or not t.units:
        return None
    us = sum(dur for name, dur, _, _ in t.attributed if "mish" in name.lower())
    return us / 1e3 / t.units if us > 0 else None
