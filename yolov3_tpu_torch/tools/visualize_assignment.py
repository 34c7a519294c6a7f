"""Visual check of the grid-scatter target assignment.

Counterpart of the JAX package's ``tools/visualize_assignment.py``, with the
same command line plus ``--device``: renders, per scale and anchor, the boxes
extracted back out of the target cubes over the source image (the first
example of the train split), through matplotlib's ``Agg`` backend.

The cubes come from the port's ``ops/assign.assign_targets`` on the device,
fed by ``data/pipeline.py`` (``create_dataset``, ``Batcher``) at the grid
sizes ``models/network.head_grid_sizes`` reads off the model; they are
bit-equal to the JAX tool's. Runs on the CUDA card unless given
``--device cpu``; with no card it raises before reading anything. The
config's paths are relative to the working directory, as in the JAX tool.

Usage (from the repo root):
  python -m yolov3_tpu_torch.tools.visualize_assignment \\
      [--config config/train_config.yaml] [--out assignment_debug.png] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device


def assignment(cfg: dict, device) -> tuple:
    """The first train example of ``cfg`` (a train config) and its target
    cubes → (image (H, W, 3) float32, tuple of (g, g, 3, 6) numpy cubes),
    the assignment run on ``device``."""
    from ..config import count_file_lines, get_anchors
    from ..data.pipeline import Batcher, create_dataset
    from ..models import parse_model_config
    from ..models.network import head_grid_sizes
    from ..ops.assign import assign_targets

    anchors = get_anchors(cfg["anchors_file"])
    nclasses = count_file_lines(cfg["classes_name_file"])
    spec = parse_model_config(cfg["model_config_file"], nclasses)
    grid_sizes = head_grid_sizes(spec, cfg["image_size"])

    ds, _ = create_dataset(cfg["dataset_config"], cfg["image_size"], cfg["max_bboxes"],
                           cfg["classes_name_file"], 4)
    images, labels = next(iter(Batcher(ds[0], 1)))
    grids = assign_targets(torch.from_numpy(np.asarray(labels)).to(device), anchors, grid_sizes)
    return images[0], tuple(g.cpu().numpy()[0] for g in grids)


def render(image, cubes, out):
    """One row a scale, one column an anchor: the cube's assigned boxes over
    ``image``, saved to ``out``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.render import render_bboxes

    fig, axes = plt.subplots(len(cubes), 3, figsize=(12, 4 * len(cubes)), squeeze=False)
    for s, cube in enumerate(cubes):  # (g, g, 3, 6)
        for a in range(3):
            rows = cube[..., a, :][cube[..., a, 4] == 1]
            img = render_bboxes(image, rows[:, :4], color=(1, 1, 1))
            axes[s][a].imshow(np.clip(img, 0, 1))
            axes[s][a].set_title(f"scale {s} (g={cube.shape[0]}), anchor {a}: {len(rows)} boxes")
            axes[s][a].axis("off")
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)


def main(argv=None):
    """Assign and render; returns the cubes (numpy, one a scale)."""
    parser = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.visualize_assignment")
    parser.add_argument("--config", type=str, default="config/train_config.yaml")
    parser.add_argument("--out", type=str, default="assignment_debug.png")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # no card and no --device cpu: raise first

    import yaml

    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    image, cubes = assignment(cfg, device)
    render(image, cubes, args.out)
    print(f"saved {args.out}")
    return cubes


if __name__ == "__main__":
    main()
