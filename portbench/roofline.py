"""H100 SXM peaks and the least time a piece of work needs on them.

Published dense rates of one H100 SXM (NVIDIA's data sheet), at its 700 W
limit; a card set lower runs slower under load, so every result prints the
card's power limit beside these. A roofline share is the least time the
work needs (the larger of its operations over the peak rate and its bytes
over the memory bandwidth, each input byte read once and each output byte
written once) over the time the device took.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "int8_chain": 1979e12, "bf16": 989e12, "fp32": 67e12,
                  "tf32": 495e12}


def bn_stats_forward_bytes(elems: int, esize: int, channels: int) -> int:
    """Training BatchNorm's statistics: the input read once, the (4, C) f32
    sums, squares, means and variances written."""
    return elems * esize + 16 * channels


def bn_stats_backward_bytes(elems: int, esize: int, channels: int) -> int:
    """Their gradient: the input read and its gradient written once, the
    three (C,) f32 vectors read."""
    return 2 * elems * esize + 12 * channels
