"""K1 — the greedy NMS suppression sweep: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``yolov3_tpu/ops/pallas/nms_kernel.py``
(``pallas_suppression_sweep`` / ``_suppress_kernel``):

    keep[i] = valid[i] ∧ ¬sup[i];   sup[j] |= keep[i] ∧ M[i, j]   for j > i

over M (B, K, K) {0,1} (IoU > threshold between score-sorted candidates)
and valid (B, K). The kernel (``csrc/nms_sweep.cu``) takes M as
bool/uint8 instead of the TPU's f32 and returns keep as bool; it runs one
thread block per image with the state in shared memory. Its note says
what bounds it (the K dependent steps, not the bytes) and what the design
does about that. The TPU's K % 128 and K ≤ 1024 limits were VMEM limits;
here any K ≤ ``MAX_SWEEP_K`` works.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_SWEEP_K = 4096  # = ops/nms.py::_MATRIX_SWEEP_MAX_K; K bytes of shared memory


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
    """(B, K, K) bool, (B, K) bool → keep (B, K) bool. CPU tensors take the
    plain version; CUDA tensors launch ``nms_sweep_kernel`` on the masks in
    place, with no copy (and count it in ``suppression_sweep.launches``), or
    raise."""
    if suppress_mat.device.type == "cpu":
        return suppression_sweep_ref(suppress_mat, valid)
    if suppress_mat.device.type != "cuda":
        raise ValueError(f"suppression_sweep: unsupported device {suppress_mat.device}")
    b, k, k2 = suppress_mat.shape
    if k != k2 or tuple(valid.shape) != (b, k):
        raise ValueError(f"suppression_sweep: shapes {tuple(suppress_mat.shape)}, "
                         f"{tuple(valid.shape)}")
    if k > MAX_SWEEP_K:
        raise ValueError(f"suppression_sweep: K={k} exceeds {MAX_SWEEP_K}")
    if valid.device != suppress_mat.device:
        raise ValueError("suppression_sweep: inputs on different devices")
    if suppress_mat.dtype != torch.bool or valid.dtype != torch.bool:
        raise ValueError(f"suppression_sweep: needs bool masks, got {suppress_mat.dtype}, "
                         f"{valid.dtype}")
    # bool and uint8 are both one byte: the kernel reads the masks in place
    mat = suppress_mat.contiguous().view(torch.uint8)
    val = valid.contiguous().view(torch.uint8)
    keep = torch.empty((b, k), dtype=torch.bool, device=mat.device)
    lib = build.library("nms_sweep")
    fn = lib.nms_sweep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        build.check(fn(mat.data_ptr(), val.data_ptr(), keep.data_ptr(), b, k, stream),
                    "nms_sweep")
    suppression_sweep.launches += 1
    return keep


suppression_sweep.launches = 0
