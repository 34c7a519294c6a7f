"""The port's CUDA kernels (yolov3_tpu_torch/ops/cuda/) against their plain
PyTorch versions, on an NVIDIA card. Marked ``cuda``; each test skips
without a card (the kernels have no CPU mode). This file imports neither
JAX nor the JAX package, so on a machine with the card and no JAX it runs
alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Inputs are made with numpy from a seed. Tolerance: none."""

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.ops.cuda import nms_kernel, round_sweep


def _sweep_case(seed, b, k, valid_frac=0.6):
    rng = np.random.RandomState(seed)
    iou = rng.rand(b, k, k).astype(np.float32)
    iou = (iou + iou.transpose(0, 2, 1)) / 2
    mat = iou > 0.7
    valid = rng.rand(b, k) < valid_frac
    return mat, valid


def _boxes_case(seed, b, n):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2) * 0.8
    wh = rng.rand(b, n, 2) * 0.3 + 0.02
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, n // 8] = boxes[:, n // 16]  # exact duplicate boxes …
    scores = (np.round(rng.rand(b, n) * 40) / 40).astype(np.float32)  # … and score ties
    scores[:, n // 8] = scores[:, n // 16]
    return boxes, scores


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(4, 100), (16, 512), (2, 4096)])
def test_cuda_sweep_equals_plain(cuda_device, b, k):
    """Tolerance: none — keep masks bit-equal to the plain version."""
    mat, valid = _sweep_case(k, b, k)
    mat_t = torch.from_numpy(mat).to(cuda_device)
    valid_t = torch.from_numpy(valid).to(cuda_device)
    before = nms_kernel.suppression_sweep.launches
    got = nms_kernel.suppression_sweep(mat_t, valid_t)
    torch.cuda.synchronize()
    assert nms_kernel.suppression_sweep.launches == before + 1
    want = nms_kernel.suppression_sweep_ref(mat_t, valid_t)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,max_boxes,score_t", [(10647, 100, 0.004), (22743, 100, 0.3),
                                                 (777, 50, 0.0)])
def test_cuda_round_sweep_equals_plain(cuda_device, n, max_boxes, score_t):
    """Tolerance: none — identical indices (the kernel's IoU rounds as the
    plain element-wise ops do)."""
    boxes, scores = _boxes_case(n, 3, n)
    bt = torch.from_numpy(boxes).to(cuda_device)
    st = torch.from_numpy(scores).to(cuda_device)
    sel, nv = round_sweep.round_sweep(bt, st, 0.5, score_t, max_boxes=max_boxes)
    torch.cuda.synchronize()
    want_sel, want_nv = round_sweep.round_sweep_ref(bt, st, 0.5, score_t, max_boxes)
    assert torch.equal(sel, want_sel) and torch.equal(nv, want_nv)
