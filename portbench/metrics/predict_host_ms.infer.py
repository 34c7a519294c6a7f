"""The median host milliseconds of a ``predict`` call in the untraced window,
from the call until it returns: the predictor's enqueue of one batch."""

from portbench.records import median_ms


def read(rec):
    return median_ms(rec, "predict")
