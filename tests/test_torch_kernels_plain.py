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
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)


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
    """The wrappers call their ``yolov3_torch`` ops, whose kernels are CPU
    (the plain version) and CUDA (the launch): a backend with neither — here
    sparse CPU tensors — raises in the dispatcher. Meta tensors take the
    fake kernel, which gives the output's shape and type (what
    ``torch.export`` traces with): no launch, no plain version."""
    dense = torch.zeros((1, 4), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="SparseCPU"):
        nms_kernel.suppression_sweep(torch.zeros((1, 4, 4)).to_sparse(), dense)
    with pytest.raises(NotImplementedError, match="SparseCPU"):
        round_sweep.round_sweep(torch.zeros((1, 4, 4)).to_sparse(), torch.zeros((1, 4)),
                                0.5, 0.1)
    before = nms_kernel.suppression_sweep.launches, round_sweep.round_sweep.launches
    keep = nms_kernel.suppression_sweep(torch.zeros((1, 4, 4), dtype=torch.bool, device="meta"),
                                        torch.zeros((1, 4), dtype=torch.bool, device="meta"))
    sel, nv = round_sweep.round_sweep(torch.zeros((1, 4, 4), device="meta"),
                                      torch.zeros((1, 4), device="meta"), 0.5, 0.1, 7)
    assert (keep.device.type, tuple(keep.shape), keep.dtype) == ("meta", (1, 4), torch.bool)
    assert (tuple(sel.shape), sel.dtype, tuple(nv.shape)) == ((1, 7), torch.int32, (1,))
    assert (nms_kernel.suppression_sweep.launches, round_sweep.round_sweep.launches) == before


def test_build_names_a_library_by_its_source_and_the_headers_it_includes(tmp_path, monkeypatch):
    """An edit to a shared header must rebuild every kernel that includes it,
    directly or through another header, and no other: ``requant.cuh`` (K3,
    K4, K6), ``int8_wgmma.cuh`` (K3, K4 and K6, which share its main loop;
    K3 and K6 also its staged epilogue)."""
    import shutil

    from yolov3_tpu_torch.ops.cuda import build

    assert set(build._with_headers("resblock_int8.cu", {})) == {
        "resblock_int8.cu", "int8_wgmma.cuh", "requant.cuh"}
    assert set(build._with_headers("nms_sweep.cu", {})) == {"nms_sweep.cu"}
    assert set(build._with_headers("conv1x1_int8.cu", {})) == {
        "conv1x1_int8.cu", "int8_mma.cuh", "int8_wgmma.cuh", "requant.cuh"}
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", str(copy))
    for header, rebuilt in (("requant.cuh", {"conv1x1_int8", "conv_int8", "resblock_int8"}),
                            ("int8_wgmma.cuh", {"conv1x1_int8", "conv_int8", "resblock_int8"})):
        before = {name: build._target(name) for name in build.SOURCES}
        with open(copy / header, "a") as f:
            f.write("// edited\n")
        after = {name: build._target(name) for name in build.SOURCES}
        assert {name for name in build.SOURCES if before[name] != after[name]} == rebuilt
