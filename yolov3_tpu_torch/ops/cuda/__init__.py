"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

  * ``nms_kernel.suppression_sweep`` (K1, ``csrc/nms_sweep.cu``) replaces
    ``yolov3_tpu/ops/pallas/nms_kernel.py::pallas_suppression_sweep``;
  * ``round_sweep.round_sweep`` (K2, ``csrc/round_sweep.cu``) replaces
    ``yolov3_tpu/ops/pallas/round_sweep.py::pallas_round_sweep``.

A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises. Each wrapper counts its kernel launches in
an integer attribute ``launches``.
"""
