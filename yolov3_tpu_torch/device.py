"""Device selection for the port: the card by default, the CPU only on request.

Every entry point takes a ``device`` argument and passes it through
``resolve_device``. ``None`` means the CUDA card; with no card present that
raises instead of falling back, so a run that was meant for the card can
never quietly measure or serve on the CPU. ``"cpu"`` is honoured when the
caller asks for it (the CPU tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` → that card (raises without one);
    ``"cpu"`` → the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "yolov3_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
