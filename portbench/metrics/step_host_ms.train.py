"""The median host milliseconds of a train ``step`` call in the untraced
window, from the call until it returns: the step's enqueue (the loop does
not wait for the device between steps)."""

from portbench.records import median_ms


def read(rec):
    return median_ms(rec, "step")
