"""The port's YOLO head decode (yolov3_tpu_torch/ops/decode.py) against the
JAX package's (yolov3_tpu/ops/decode.py) on the same seeded logits.

Tolerance: 1e-5 absolute in float32 (sigmoid/exp are computed by two
libraries' own elementwise kernels, so the last ulp may differ)."""

import numpy as np
import pytest
import torch

from yolov3_tpu.ops.decode import yolo_decode as jax_decode
from yolov3_tpu_torch.ops.decode import yolo_decode

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
