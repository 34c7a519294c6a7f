"""Serving artifacts: the whole serving predictor as a ``torch.export`` program.

Counterpart of ``yolov3_tpu/export/aot.py``. The serving body
(``apps/inference_app.py::Detector``: forward → ``yolo_decode`` →
``yolo_nms``, in whichever tier was configured — fp32, bf16, int8 PTQ,
``int8_chain``) is exported over a **symbolic batch** with its folded (or
quantized) params lifted into the program, so one artifact serves every
batch size. The hand-written kernels stay kernels: each is a
``torch.library`` op (``yolov3_torch::…``, ``ops/cuda/``) and a node of the
program, whose CPU kernel is its plain version and whose CUDA kernel launches
it. Loading needs this module and those op registrations: no model configs,
no weights pipeline, no model code.

Artifact format: one zip file holding
  ``manifest.json``       run metadata — image size, class names, NMS
                          parameters, quantize tier, the torch and format
                          versions, the platforms (the JAX manifest's keys,
                          with ``framework: "yolov3_tpu_torch"`` and
                          ``torch_version`` in place of ``jax_version``),
                          and ``fp32_precision: "ieee"``, which the loader
                          applies (``device.pin_fp32_ieee``);
  ``module.<platform>.pt2``  one ``torch.export.save`` program per platform
                          (``cpu``, ``cuda``): a program bakes its device
                          into ops such as ``arange`` and ``zeros``, so each
                          platform's is exported from the module moved to
                          that device, with the same params.

Producer: ``apps/export_app.py`` (``python -m yolov3_tpu_torch.apps.cli
export``). Consumers: ``load_detector_artifact`` below and the serve
command's ``artifact:`` key. An artifact of the JAX package
(``module.jaxexport``) is refused by name, and so is a platform the artifact
has no program for: there is no fallback to another device.
"""

from __future__ import annotations

import copy
import io
import json
import time
import zipfile

import torch

from ..device import pin_fp32_ieee, resolve_device
from ..ops import cuda as _kernels  # noqa: F401  (registers the yolov3_torch ops)

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 1
JAX_MODULE_NAME = "module.jaxexport"
PLATFORMS = ("cpu", "cuda")


def module_name(platform: str) -> str:
    return f"module.{platform}.pt2"


def as_predict(module, device):
    """``predict(images)``: (B, H, W, 3) float32 images in [0, 1], numpy or
    tensor → ``module``'s ``yolo_nms`` tuple ``(bboxes, class_idx, scores,
    selected, num_valid)`` of tensors on ``device``, under
    ``inference_mode``. The eager predictor (``make_predictor``) and a loaded
    artifact both answer through it; ``predict.device`` and
    ``predict.module`` say what it runs."""

    @torch.inference_mode()
    def predict(images):
        return tuple(module(torch.as_tensor(images, dtype=torch.float32, device=device)))

    predict.device, predict.module = device, module
    return predict


def export_detector(module, image_size: int, platforms=PLATFORMS):
    """Export ``module`` (an ``inference_app.Detector``) over a symbolic
    batch: each program takes ``(b, H, W, 3)`` float32 for any b ≥ 1.
    Returns ``{platform: torch.export.ExportedProgram}``. A platform other
    than the module's own is exported from a copy moved there, so the same
    params (an int8 tier's quantization included) go to every platform; the
    module itself is not moved."""
    size = int(image_size)
    batch = torch.export.Dim("b", min=1)
    programs = {}
    for platform in platforms:
        if platform not in PLATFORMS:
            raise ValueError(f"platform must be one of {PLATFORMS}, got {platform!r}")
        device = resolve_device(platform)
        here = module if module.anchors.device.type == platform else copy.deepcopy(module).to(
            device)
        # torch specializes a batch of 1, so the example batch is 2
        example = torch.zeros((2, size, size, 3), dtype=torch.float32, device=device)
        with torch.no_grad():
            programs[platform] = torch.export.export(here, (example,),
                                                     dynamic_shapes=({0: batch},), strict=False)
    return programs


def save_detector_artifact(path: str, exported: dict, manifest: dict) -> dict:
    """Write the artifact zip (``exported``: ``export_detector``'s
    programs); returns the full manifest as written."""
    manifest = dict(manifest)
    manifest.setdefault("format_version", FORMAT_VERSION)
    manifest.setdefault("framework", "yolov3_tpu_torch")
    manifest.setdefault("torch_version", torch.__version__)
    manifest.setdefault("platforms", list(exported))
    manifest.setdefault("created_unix", int(time.time()))
    manifest.setdefault("fp32_precision", "ieee")
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(MANIFEST_NAME, json.dumps(manifest, indent=2, sort_keys=True))
        for platform, program in exported.items():
            blob = io.BytesIO()
            torch.export.save(program, blob)
            # a .pt2 is itself a zip archive: store it as it is
            zf.writestr(zipfile.ZipInfo(module_name(platform)), blob.getvalue())
    return manifest


def load_detector_artifact(path: str, device=None):
    """Load an artifact → ``(predict, manifest)``, on the card unless
    ``device="cpu"`` (``device.resolve_device``: with no card, asking for it
    raises).

    ``predict(images)`` takes ``(B, H, W, 3)`` float32 in [0, 1] (square
    ``manifest["image_size"]`` resize, /255; letterboxed when
    ``manifest["letterbox"]``) and returns the ``yolo_nms`` tuple, as
    ``make_predictor``'s predictor does (``as_predict``). One program serves
    every batch size; its weights live in the program. The manifest's
    ``fp32_precision`` is applied before the program is loaded (an artifact
    written before the key existed is ``"ieee"``, the only value). Raises
    for a JAX artifact, for a newer ``format_version``, for another
    ``fp32_precision`` and for an artifact with no program for the device."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path, "r") as zf:
        names = set(zf.namelist())
        if JAX_MODULE_NAME in names:
            raise ValueError(
                f"{path} is an artifact of the JAX package ({JAX_MODULE_NAME}, written by "
                "yolov3_tpu.export.aot); load it with yolov3_tpu.export.load_detector_artifact, "
                "or export one for this package with python -m yolov3_tpu_torch.apps.cli export")
        manifest = json.loads(zf.read(MANIFEST_NAME).decode())
        # the version gate comes before the program bytes are touched
        version = int(manifest.get("format_version", 0))
        if version > FORMAT_VERSION:
            raise ValueError(f"artifact {path} has format_version {version}; this loader "
                             f"understands ≤ {FORMAT_VERSION} — upgrade yolov3_tpu_torch")
        member = module_name(dev.type)
        if member not in names:
            raise ValueError(f"artifact {path} has no program for {dev.type} (it holds "
                             f"{manifest.get('platforms')}); export it with that platform")
        precision = manifest.get("fp32_precision", "ieee")
        if precision != "ieee":
            raise ValueError(f"artifact {path} asks for fp32_precision {precision!r}; this "
                             "loader runs fp32 as IEEE fp32 only")
        pin_fp32_ieee(dev)
        program = torch.export.load(io.BytesIO(zf.read(member)))
    return as_predict(program.module(), dev), manifest
