"""The one generator of traffic: a cell's data file
(``workloads/<cell>.json``: its batch, boxes an image, box sides) and
``--seed`` → the inputs, made on the run's device in a few large draws.

  * ``image_pool``: ``pool`` batches of uint8 images (B, S, S, 3),
    staged on the device once, as a serving or training path receives them;
  * ``derived``: batch ``i`` of a window, ``(pool[i mod P] + i) mod 256``
    as uint8, then × f32(1/255): every batch's pixels differ, no host copy
    is timed (the measurement tools' ``derived_images``);
  * ``calibration_images``: float images for the int8 tiers' calibration,
    on the host, as ``make_predictor`` takes them;
  * ``label_pool``: padded label rows (P, B, LABEL_ROWS, 6) ``[xmin, ymin, xmax,
    ymax, 1, class]``: a count of boxes an image uniform over
    ``boxes_per_image``, sides log-uniform over ``box_side`` of the image,
    centres uniform where the box fits, classes uniform; rows past the count
    all zero.

The program receives only these inputs; it never sees the seed.
"""

from __future__ import annotations

import math

import torch

from .weights import generator

LABEL_ROWS = 100  # config/train_config.yaml's max_bboxes: the rows a label batch is padded to


def image_pool(seed: int, pool: int, batch: int, size: int, device):
    g = generator(device, seed, 2)
    return torch.randint(0, 256, (pool, batch, size, size, 3), generator=g, device=device,
                         dtype=torch.uint8)


def derived(pool, i: int):
    """Batch ``i``'s float32 images from the staged uint8 pool."""
    return (pool[i % pool.shape[0]] + (i % 256)).to(torch.float32) * (1.0 / 255.0)


def calibration_images(seed: int, n: int, size: int, device):
    g = generator(device, seed, 3)
    return (torch.randint(0, 256, (n, size, size, 3), generator=g, device=device)
            .to(torch.float32) * (1.0 / 255.0)).cpu().numpy()


def label_pool(seed: int, pool: int, batch: int, cell: dict, nclasses: int, device):
    lo_n, hi_n = cell["boxes_per_image"]
    lo_s, hi_s = cell["box_side"]
    rows = LABEL_ROWS
    g = generator(device, seed, 4)
    shape = (pool, batch, rows)
    count = torch.randint(lo_n, hi_n + 1, (pool, batch, 1), generator=g, device=device)
    u = torch.rand(shape + (4,), generator=g, device=device)
    wh = torch.exp(math.log(lo_s) + u[..., 0:2] * (math.log(hi_s) - math.log(lo_s)))
    lo = u[..., 2:4] * (1.0 - wh)
    cls = torch.randint(0, nclasses, shape, generator=g, device=device).float()
    labels = torch.cat([lo, lo + wh, torch.ones(shape + (1,), device=device), cls[..., None]], -1)
    live = torch.arange(rows, device=device)[None, None, :] < count
    return torch.where(live[..., None], labels, torch.zeros((), device=device))
