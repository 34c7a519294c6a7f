"""The port's NMS kernels (yolov3_tpu_torch/ops/cuda/): each plain PyTorch
version against the JAX package's Pallas TPU kernel in interpret mode,
exactly (bit-equal keep masks / identical indices). The CUDA kernels
against their plain versions are in test_torch_kernels_cuda.py.

Inputs are made with numpy from a seed and handed to both frameworks."""

import numpy as np
import pytest
import torch

from yolov3_tpu.ops.pallas.nms_kernel import pallas_suppression_sweep
from yolov3_tpu.ops.pallas.round_sweep import pallas_round_sweep
from yolov3_tpu_torch.ops.cuda import nms_kernel, round_sweep

from .test_torch_kernels_cuda import _boxes_case, _sweep_case


@pytest.mark.parametrize("b,k", [(2, 16), (2, 128), (1, 200)])
def test_sweep_plain_equals_pallas_interpret(b, k):
    """Tolerance: none — keep masks bit-equal."""
    mat, valid = _sweep_case(k, b, k)
    want = np.asarray(pallas_suppression_sweep(mat.astype(np.float32),
                                               valid.astype(np.float32),
                                               interpret=True)) > 0.5
    got = nms_kernel.suppression_sweep(torch.from_numpy(mat), torch.from_numpy(valid))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_sweep_cpu_wrapper_does_not_count_launches():
    mat, valid = _sweep_case(0, 1, 8)
    before = nms_kernel.suppression_sweep.launches
    nms_kernel.suppression_sweep(torch.from_numpy(mat), torch.from_numpy(valid))
    assert nms_kernel.suppression_sweep.launches == before


@pytest.mark.parametrize("n,max_boxes,score_t", [(300, 40, 0.3), (257, 20, 0.0),
                                                 (300, 60, 0.95)])
def test_round_sweep_plain_equals_pallas_interpret(n, max_boxes, score_t):
    """Tolerance: none — identical selected indices and counts."""
    boxes, scores = _boxes_case(n + max_boxes, 2, n)
    want_sel, want_nv = pallas_round_sweep(boxes, scores, 0.5, score_t,
                                           max_boxes=max_boxes, interpret=True)
    sel, nv = round_sweep.round_sweep(torch.from_numpy(boxes), torch.from_numpy(scores),
                                      0.5, score_t, max_boxes=max_boxes)
    assert sel.dtype == torch.int32 and nv.dtype == torch.int32
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(want_nv))


def test_wrappers_raise_on_unsupported_device():
    mat = torch.zeros((1, 4, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        nms_kernel.suppression_sweep(mat, torch.zeros((1, 4), dtype=torch.bool,
                                                      device="meta"))
    with pytest.raises(ValueError):
        round_sweep.round_sweep(torch.zeros((1, 4, 4), device="meta"),
                                torch.zeros((1, 4), device="meta"), 0.5, 0.1)
