"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

  * ``nms_kernel.suppression_sweep`` (K1, ``csrc/nms_sweep.cu``) replaces
    ``yolov3_tpu/ops/pallas/nms_kernel.py::pallas_suppression_sweep``;
  * ``round_sweep.round_sweep`` (K2, ``csrc/round_sweep.cu``) replaces
    ``yolov3_tpu/ops/pallas/round_sweep.py::pallas_round_sweep``;
  * ``conv1x1.conv1x1_int8_requant`` (K3, ``csrc/conv1x1_int8.cu``) replaces
    ``yolov3_tpu/ops/pallas/conv1x1.py::conv1x1_int8_requant``;
  * ``resblock.fused_resblock`` (K4, ``csrc/resblock_int8.cu`` on the
    ``wgmma`` machinery of ``csrc/int8_wgmma.cuh``) replaces
    ``yolov3_tpu/ops/pallas/resblock.py::fused_resblock``;
  * ``bn_stats.bn_moments`` (K5, ``csrc/bn_stats.cu``: ``bn_sums`` /
    ``bn_moments`` forward in one launch, ``bn_moments_dx`` backward in one)
    replaces ``yolov3_tpu/ops/pallas/bn_stats.py::bn_sums`` / ``bn_moments``;
  * ``conv_int8.conv_int8`` (K6, ``csrc/conv_int8.cu`` on the ``wgmma`` main
    loop of ``csrc/int8_wgmma.cuh``) is the int8 k×k conv that the JAX package
    leaves to XLA and PyTorch does not have on CUDA;
  * ``csrc/requant.cuh`` (K0) is the int8 epilogue K3, K4 and K6 share, the
    counterpart of ``yolov3_tpu/ops/pallas/common.py``; ``requant.py`` is its
    plain version;
  * ``bn_leaky.bn_leaky`` (K7, ``csrc/bn_leaky.cu``) is the training
    BatchNorm tail, normalize and LeakyReLU in one launch each way;
  * ``bias_act.bias_act`` (K8, ``csrc/bias_act.cu``) is every folded fp
    conv's tail that autograd does not record, bias add and activation
    (linear, leaky, Mish) in one launch. K7 and K8 share the element helpers
    of ``csrc/elementwise.cuh``.

``build.py`` compiles and loads the sources and sets every launch function's
ctypes signature once; ``kernel_times.py`` times K1–K8 alone on a card.

K1, K2, K3, K4, K6 and K8 are ``torch.library`` custom ops in the
``yolov3_torch`` namespace (``torch.ops.yolov3_torch.suppression_sweep``,
``round_sweep``, ``conv1x1_int8_requant``, ``conv_int8``,
``fused_resblock``, ``bias_act``), registered when this package is
imported: each op's CPU kernel is the plain version, its CUDA kernel the
launch (the only place the kernel's ctypes function is called), and its fake
kernel gives the output's shape and type at a symbolic batch, so
``torch.export`` keeps each kernel as one node of an exported program
(``export/aot.py``). The wrappers keep their
names and signatures and call the op. K5 and K7 stay direct wrappers with
their ``torch.autograd.Function``: they run in training and recalibration
only, and BatchNorm is folded at serving.

A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises. Each wrapper counts its kernel launches in
an integer attribute ``launches``, which the op's CUDA kernel increments: a
loaded program's launches count too.
"""

from . import bias_act, conv1x1, conv_int8, nms_kernel, resblock, round_sweep  # noqa: F401
