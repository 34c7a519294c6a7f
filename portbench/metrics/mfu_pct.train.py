"""The train step's share of the chip's peak: three forwards' FLOPs an image
(the forward and the backward's two products) × the images stepped in the
untraced window, over its wall time, over the peak of the cell's training
precision (``roofline.py``: bf16 989 TFLOP/s)."""

from portbench.records import mfu_pct
from portbench.roofline import PEAK_OPS_PER_S


def read(rec):
    return mfu_pct(rec, 3.0, PEAK_OPS_PER_S[rec.cell["precision"]])
