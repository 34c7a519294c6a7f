"""yolov3_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of yolov3_tpu.

The JAX package ``yolov3_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find, imports ``torch`` and never
``jax`` (nor anything of ``yolov3_tpu``), and carries hand-written CUDA
kernels for the Pallas TPU kernels on its path (``ops/cuda/``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``device.resolve_device``); there is no silent fallback.
"""

__version__ = "0.1.0"
