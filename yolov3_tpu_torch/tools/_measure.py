"""Shared helpers of the port's measurement tools (``bench``,
``latency_bench``, ``profile_inference``, ``mfu_table``, ``profile_eval``,
``profile_train``, ``bench_resblock``).

The methodology of the JAX package's ``bench.py``, as this card runs it:

  * the input batch is staged on the device once, as uint8 (what a serving
    path receives), and each iteration's images are derived from it on the
    device: ``(base + i) mod 256`` as uint8, then ``* (1/255)`` in float32.
    The derivation costs one element-wise pass; no host-to-device copy is
    timed;
  * the JAX tools run a pass as one compiled loop. Here every iteration's
    launches are queued by the host as it goes, so a pass's host clock holds
    the host's launches too, which is the cost a co-located host pays. Each
    iteration leaves a scalar checksum on the device, and a pass fetches them
    once, after ``torch.cuda.synchronize()``;
  * every result names the device it ran on (``device_record``): the card's
    name, the device count and the power limit ``nvidia-smi`` reports, or
    ``"cpu"``. A CPU run measures PyTorch's CPU kernels, never the card.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@functools.lru_cache(maxsize=None)
def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card's line)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def device_record(device):
    """What a result prints about where it ran: ``"cpu"``, or the card's name,
    the device count and ``nvidia_smi()``'s line."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    return {"kind": torch.cuda.get_device_name(device), "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi()}


def device_text(record) -> str:
    """``device_record`` in a text line: ``cpu``, or its JSON."""
    return record if record == "cpu" else json.dumps(record)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def staged_uint8(batch: int, image_size: int, device, seed: int = 0):
    """The staged uint8 batch (B, S, S, 3) of ``RandomState(seed)``, on ``device``."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        rng.randint(0, 256, (batch, image_size, image_size, 3)).astype(np.uint8)).to(device)


def derived_images(base_u8, i: int):
    """Iteration ``i``'s float32 images: ``(base + i) mod 256`` as uint8, times
    the float32 1/255 (the JAX bench's ``xu.astype(f32) * (1.0 / 255.0)``)."""
    return (base_u8 + (int(i) % 256)).to(torch.float32) * (1.0 / 255.0)


def detections_checksum(boxes, scores, valid):
    """Sum of the boxes, the scores and the valid mask: a scalar on the device."""
    return boxes.sum() + scores.sum() + valid.sum()


def host_seconds(fn, device):
    """Host seconds of ``fn()`` ending in a synchronize → (seconds, result)."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def repo_path(path: str) -> str:
    """A path relative to the repository root (absolute paths pass through)."""
    return os.path.join(REPO, path)


def seeded_anchors(nheads: int) -> np.ndarray:
    """The JAX tools' anchors: ``|RandomState(0).randn(nheads, 3, 2)| * 0.2 + 0.05``."""
    return (np.abs(np.random.RandomState(0).randn(nheads, 3, 2)).astype(np.float32) * 0.2
            + 0.05)


def build_tier(model_config_file, nclasses: int, quantize: str, image_size: int, device,
               calibration_images: int = 8, score_threshold: float = 0.25):
    """The serving tier the JAX tools build, through ``make_predictor``: the
    model's Keras-default weights from ``torch.Generator().manual_seed(0)``,
    BatchNorm folded, then ``"bf16"`` (weights and images in bf16), ``"fp32"``,
    or ``"int8"`` / ``"int8_chain"`` calibrated on ``calibration_images``
    images of ``RandomState(7)`` with the space-to-depth stem (their fp parts
    run in float32, as ``make_predictor`` builds the int8 tiers; the JAX
    tools cast the images to bf16 for every tier). Returns the
    ``inference_app.Detector``; its anchors are ``seeded_anchors``."""
    from ..apps.inference_app import make_predictor
    from ..models import init_model, parse_model_config
    from ..models.network import head_grid_sizes

    spec = parse_model_config(repo_path(model_config_file), nclasses)
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    anchors = seeded_anchors(len(head_grid_sizes(spec, image_size)))
    if quantize in ("int8", "int8_chain"):
        rng = np.random.RandomState(7)
        tier = dict(quantize=quantize, calibration_batches=[
            rng.rand(calibration_images, image_size, image_size, 3).astype(np.float32)])
    elif quantize in ("bf16", "fp32"):
        tier = dict(compute_dtype=torch.bfloat16 if quantize == "bf16" else None)
    else:
        raise ValueError(f"quantize must be int8, int8_chain, bf16 or fp32, got {quantize!r}")
    return make_predictor(spec, params, state, anchors, nclasses, 100, 0.5, score_threshold,
                          image_size=image_size, device=device, **tier).module


def tier_inputs(module, images):
    """Images in the dtype the tier's forward takes (bf16 for the bf16 tier,
    float32 otherwise)."""
    return images if module.compute_dtype is None else images.to(module.compute_dtype)
