"""The model step's share of the chip's peak: one forward's FLOPs an image
(``flops.py``) × the images whose detections reached the host in the
untraced window, over its wall time, over the peak of the cell's tier
(``roofline.py``: int8 1,979 TOP/s, bf16 989 TFLOP/s)."""

from portbench.records import mfu_pct
from portbench.roofline import PEAK_OPS_PER_S


def read(rec):
    return mfu_pct(rec, 1.0, PEAK_OPS_PER_S[rec.cell["tier"]])
