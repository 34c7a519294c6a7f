"""Device milliseconds a batch of the kernels a ``predict`` call launches
outside every layer range: the input cast, decode, suppression (K1) and
what surrounds them."""


def read(rec):
    t = rec.trace
    if t is None or not t.units:
        return None
    us = sum(dur for _, dur, layer, span in t.attributed if layer is None and span == "predict")
    return us / 1e3 / t.units if us > 0 else None
