"""Darknet .weights → native checkpoint converter (reference convert.py surface).

Counterpart of ``yolov3_tpu/apps/convert_app.py``. Config schema
(utilities/convert_config.yaml): num_classes, weights_file,
output_weights_file, model_config_file (a model YAML or a Darknet ``.cfg``),
and ``device`` (the card unless ``cpu``). Loads the binary weights in conv
order, sanity-checks a 416×416 forward of a seeded uniform image on the
device (reference convert.py:166-168), and writes a native ``.npz`` in the
JAX package's key layout, which either package loads.
"""

from __future__ import annotations

import logging
import time

import torch

from ..device import resolve_device
from ..io.darknet import load_darknet_weights
from ..io.resolve import save_weights
from ..models import apply_model, parse_model_config
from ..models.network import to_device

log = logging.getLogger(__name__)


def convert(convert_config: dict):
    """Convert one ``.weights`` file; returns ``(spec, params, state)`` (CPU
    trees). Raises ``ValueError`` when the sanity forward is not finite, and
    then writes nothing."""
    if convert_config.get("compilation_cache"):
        log.info("compilation_cache: nothing is compiled ahead of time here; no effect")
    dev = resolve_device(convert_config.get("device"))
    nclasses = convert_config["num_classes"]
    output_weights_file = convert_config["output_weights_file"]
    spec = parse_model_config(convert_config["model_config_file"], nclasses)

    t0 = time.monotonic()
    params, state = load_darknet_weights(spec, convert_config["weights_file"])
    t1 = time.monotonic()
    p_dev, s_dev = to_device(params, dev), to_device(state, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.monotonic()
    img = torch.rand((1, 416, 416, 3), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        outs = apply_model(spec, p_dev, s_dev, img.to(dev))
        finite = all(bool(torch.isfinite(o).all()) for o in outs)
    t3 = time.monotonic()
    if not finite:
        raise ValueError("sanity check failed: non-finite outputs after conversion")
    print("sanity check passed")

    save_weights(spec, params, state, output_weights_file)
    t4 = time.monotonic()
    print(f"weights saved to {output_weights_file}")
    log.info("convert seconds: read %.3f, to %s %.3f, forward %.3f, write %.3f",
             t1 - t0, dev.type, t2 - t1, t3 - t2, t4 - t3)
    return spec, params, state
