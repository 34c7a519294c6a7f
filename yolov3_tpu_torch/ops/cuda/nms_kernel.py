"""K1 — the greedy NMS suppression sweep: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``yolov3_tpu/ops/pallas/nms_kernel.py``
(``pallas_suppression_sweep`` / ``_suppress_kernel``):

    keep[i] = valid[i] ∧ ¬sup[i];   sup[j] |= keep[i] ∧ M[i, j]   for j > i

over M (B, K, K) {0,1} (IoU > threshold between score-sorted candidates)
and valid (B, K). The kernel (``csrc/nms_sweep.cu``) takes M as
bool/uint8 instead of the TPU's f32 and returns keep as bool. It packs each
image's rows into bits and sweeps them with one warp, K/32 word steps (its
note says why) in one launch, a block an image holding the packed matrix in
shared memory. The TPU's K % 128 limit was a VMEM layout limit and is gone;
its K ≤ 1024 becomes K ≤ ``MAX_SWEEP_K`` = 1300, what that shared memory
holds (``ops/nms.py`` sends K above 512 to the round sweep).

The kernel is reached only through the ``yolov3_torch::suppression_sweep``
op (``torch.library``), registered at import: its CPU kernel is the plain
version, its CUDA kernel the launch, and its fake kernel gives the output's
shape, so ``torch.export`` records the op as one node of a program. The CUDA
kernels of these ops make their operands contiguous rather than refuse
other strides: a loaded program replays the graph with strides that need not
be the trace's (on an H100, YOLOv3-416's stem conv input came out of a
loaded program with its H and W strides swapped, where the trace had it
contiguous and had dropped the ``.contiguous()`` of the eager code).
"""

from __future__ import annotations

import torch

from . import build

MAX_SWEEP_K = 1300  # largest K whose packed matrix fits one block's shared memory


def suppression_sweep_ref(suppress_mat, valid):
    """Plain PyTorch version (mirrors ``nms_kernel.py::reference_sweep``):
    (B, K, K) bool, (B, K) bool → keep (B, K) bool."""
    b, k, _ = suppress_mat.shape
    mat = suppress_mat.bool()
    keep = torch.zeros((b, k), dtype=torch.bool, device=mat.device)
    sup = torch.zeros((b, k), dtype=torch.bool, device=mat.device)
    later = torch.arange(k, device=mat.device)
    valid = valid.bool()
    for i in range(k):
        keep_i = valid[:, i] & ~sup[:, i]
        keep[:, i] = keep_i
        sup |= mat[:, i, :] & keep_i[:, None] & (later > i)
    return keep


def suppression_sweep(suppress_mat, valid):
    """(B, K, K) bool, (B, K) bool → keep (B, K) bool, through the
    ``yolov3_torch::suppression_sweep`` op: CPU tensors take the plain
    version; CUDA tensors run the kernel on the masks in place, with no copy
    (one launch, counted in ``suppression_sweep.launches``), or raise."""
    return torch.ops.yolov3_torch.suppression_sweep.default(suppress_mat, valid)


suppression_sweep.launches = 0


@torch.library.custom_op("yolov3_torch::suppression_sweep", mutates_args=(), device_types="cpu")
def _sweep_op(suppress_mat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return suppression_sweep_ref(suppress_mat, valid)


@_sweep_op.register_kernel("cuda")
def _sweep_cuda(suppress_mat, valid):
    b, k, k2 = suppress_mat.shape
    if k != k2 or tuple(valid.shape) != (b, k):
        raise ValueError(f"suppression_sweep: shapes {tuple(suppress_mat.shape)}, "
                         f"{tuple(valid.shape)}")
    if k > MAX_SWEEP_K:
        raise ValueError(f"suppression_sweep: K={k} exceeds the {MAX_SWEEP_K} the kernel takes "
                         "(a YOLOV3_NMS_MATRIX_MAX_K above it sends such K to this kernel)")
    if valid.device != suppress_mat.device:
        raise ValueError("suppression_sweep: inputs on different devices")
    if suppress_mat.dtype != torch.bool or valid.dtype != torch.bool:
        raise ValueError(f"suppression_sweep: needs bool masks, got {suppress_mat.dtype}, "
                         f"{valid.dtype}")
    # bool and uint8 are both one byte: the kernel reads the masks in place
    mat = suppress_mat.contiguous().view(torch.uint8)
    val = valid.contiguous().view(torch.uint8)
    keep = torch.empty((b, k), dtype=torch.bool, device=mat.device)
    build.launch(build.function("nms_sweep", "nms_sweep_launch"), mat.device, "nms_sweep",
                 mat.data_ptr(), val.data_ptr(), keep.data_ptr(), b, k)
    suppression_sweep.launches += 1
    return keep


@_sweep_op.register_fake
def _sweep_fake(suppress_mat, valid):
    return suppress_mat.new_empty(suppress_mat.shape[:2], dtype=torch.bool)
