"""Device selection for the port: the card by default, the CPU only on request.

Every entry point takes a ``device`` argument and passes it through
``resolve_device``. ``None`` means the CUDA card; with no card present that
raises instead of falling back, so a run that was meant for the card can
never quietly measure or serve on the CPU. ``"cpu"`` is honoured when the
caller asks for it (the CPU tests do). Under an initialized
``torch.distributed`` process group the card is this process's own
(``local_rank``): one process drives one card.

fp32 on the card is IEEE fp32 (``pin_fp32_ieee``): PyTorch runs cuDNN's
fp32 convolutions in TF32 unless told otherwise, and the fp32 tier is the
port's parity tier. The setting is process-wide; a bf16 or int8 tier is
unaffected, since TF32 touches only fp32 operations.
"""

from __future__ import annotations

import logging
import os

import torch

log = logging.getLogger(__name__)

# torch ≥ 2.9 has per-backend ``fp32_precision`` settings beside the legacy flags
_NEW_TF32_API = hasattr(torch.backends.cudnn, "conv")


def local_rank() -> int:
    """This process's card index on its host: ``LOCAL_RANK`` (torchrun sets
    it), else the rank modulo the visible cards (several processes given one
    card all take card 0)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return torch.distributed.get_rank() % max(torch.cuda.device_count(), 1)


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` → that card (raises without one);
    ``"cpu"`` → the CPU. ``None`` and ``"cuda"`` under an initialized process
    group are ``cuda:<local_rank()>``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "yolov3_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if (dev.type == "cuda" and dev.index is None and torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        dev = torch.device("cuda", local_rank())
    return dev


def _setting(*levels) -> str:
    """The first level that is set: ``"none"`` defers to the next, and a
    chain of them is IEEE (the legacy flags, set to TF32, read "tf32")."""
    return next((v for v in levels if v != "none"), "ieee")


def fp32_precision() -> str:
    """``"ieee"`` when fp32 convolutions and matmuls on the card run in IEEE
    fp32, else ``"tf32"``."""
    if _NEW_TF32_API:
        root = torch.backends.fp32_precision
        ieee = (_setting(torch.backends.cudnn.conv.fp32_precision,
                         torch.backends.cudnn.fp32_precision, root) == "ieee"
                and _setting(torch.backends.cuda.matmul.fp32_precision, root) == "ieee")
    else:
        ieee = (not torch.backends.cudnn.allow_tf32
                and not torch.backends.cuda.matmul.allow_tf32
                and torch.get_float32_matmul_precision() == "highest")
    return "ieee" if ieee else "tf32"


def pin_fp32_ieee(device) -> None:
    """Run fp32 convolutions and matmuls in IEEE fp32 (no TF32) for the rest
    of the process, when ``device`` is a card; logged once, when it changes
    the setting. The CPU has no TF32: nothing to do there."""
    if torch.device(device).type != "cuda" or fp32_precision() == "ieee":
        return
    # the legacy flags first: torch ≥ 2.9 holds them against the new settings
    # whenever a legacy flag is read (torch.export reads cuDNN's) and raises
    # where the two disagree, as the new settings alone leave them
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if _NEW_TF32_API:
        torch.backends.cudnn.conv.fp32_precision = "ieee"
        torch.backends.cuda.matmul.fp32_precision = "ieee"
    log.info("fp32 on the card pinned to IEEE (no TF32 in cuDNN convolutions or matmuls); "
             "the setting is process-wide")
