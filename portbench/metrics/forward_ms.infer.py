"""Device milliseconds a batch of the kernels attributed to the port's layer
ranges (``L|<sub-model>|<layer>|<kind>``, and a fused stage's one range)."""


def read(rec):
    t = rec.trace
    if t is None or not t.units:
        return None
    us = sum(dur for _, dur, layer, _ in t.attributed if layer is not None)
    return us / 1e3 / t.units if us > 0 else None
