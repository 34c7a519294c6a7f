"""The port's YOLO head decode (yolov3_tpu_torch/ops/decode.py) against the
JAX package's (yolov3_tpu/ops/decode.py) on the same seeded logits.

Tolerance: 1e-5 absolute in float32 (sigmoid/exp are computed by two
libraries' own elementwise kernels, so the last ulp may differ)."""

import numpy as np
import pytest
import torch

from yolov3_tpu.ops.decode import yolo_decode as jax_decode
from yolov3_tpu_torch.ops.decode import yolo_decode

from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

TOL = 1e-5


@pytest.mark.parametrize("grids,nc", [((3, 6, 12), 80), ((4, 8), 3)])
def test_decode_matches_jax(grids, nc):
    rng = np.random.RandomState(len(grids) * 100 + nc)
    heads = [(rng.randn(2, g, g, 3, 5 + nc) * 2).astype(np.float32) for g in grids]
    anchors = (rng.rand(len(grids), 3, 2) * 0.5 + 0.02).astype(np.float32)
    want = jax_decode(heads, anchors, nc)
    got = yolo_decode([torch.from_numpy(h) for h in heads], anchors, nc)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_decode_bf16_heads_decode_in_float32():
    rng = np.random.RandomState(5)
    head = torch.from_numpy(rng.randn(1, 2, 2, 3, 8).astype(np.float32))
    anchors = np.full((1, 3, 2), 0.1, np.float32)
    outs = yolo_decode([head.to(torch.bfloat16)], anchors, 3)
    assert all(o.dtype == torch.float32 for o in outs)
    ref = yolo_decode([head.to(torch.bfloat16).float()], anchors, 3)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)


def test_extreme_wh_logits_overflow_alike():
    """Raw heads with w/h logits up to ±100 (exp overflows f32 above ~88.7)
    and a NaN logit: the port's boxes are inf/NaN exactly where JAX's are,
    and the finite values agree within 1e-5 relative (floor 1e-5)."""
    rng = np.random.RandomState(9)
    heads = [(rng.randn(2, g, g, 3, 8) * 3).astype(np.float32) for g in (3, 6)]
    for h in heads:
        h[..., 2:4] = rng.uniform(-100, 100, h[..., 2:4].shape).astype(np.float32)
    heads[0][0, 1, 1, 2, 2:4] = [88.0, 89.0]       # just below / above exp's f32 overflow
    heads[1][1, 0, 0, 0, 2] = np.nan
    anchors = (rng.rand(2, 3, 2) * 0.5 + 0.02).astype(np.float32)
    want = [np.asarray(w) for w in jax_decode(heads, anchors, 3)]
    got = [g.numpy() for g in yolo_decode([torch.from_numpy(h) for h in heads], anchors, 3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(np.isposinf(g), np.isposinf(w))
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=1e-5)
    boxes = want[0]
    assert np.isinf(boxes).any() and np.isnan(boxes).any() and np.isfinite(boxes).any()
