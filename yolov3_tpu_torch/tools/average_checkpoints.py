"""Checkpoint averaging (SWA-style), numpy only.

Counterpart of the JAX package's ``tools/average_checkpoints.py``. Averages
N native ``.npz`` weight checkpoints elementwise (params AND the BN moving
statistics — both must be averaged together or the folded inference
statistics drift), in float64 and cast back to each leaf's dtype, and writes
a new checkpoint that every app of either package loads. Classic use:
average the last K epoch snapshots for a flatter minimum (Izmailov et al.,
arXiv 1803.05407), with ``weights_save_peroid`` producing the snapshots. It
touches no device.

    python -m yolov3_tpu_torch.tools.average_checkpoints --out avg.tf ckpt_a.tf ckpt_b.tf …
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io.checkpoint import _flatten, _nest, load_checkpoint, save_checkpoint
from ..io.resolve import native_path


def average_checkpoints(paths, out_path):
    """Elementwise mean of the checkpoints' flat arrays; key sets must match
    exactly (else ``ValueError``). Returns the number of arrays averaged."""
    if len(paths) < 2:
        raise ValueError("need at least two checkpoints to average")
    flats = [_flatten(load_checkpoint(native_path(p))[0]) for p in paths]
    keys = set(flats[0])
    for p, fl in zip(paths[1:], flats[1:]):
        if set(fl) != keys:
            missing = keys.symmetric_difference(fl)
            raise ValueError(f"{p}: key set differs from {paths[0]} "
                             f"(e.g. {sorted(missing)[:5]})")

    mean_flat = {k: np.mean([fl[k].astype(np.float64) for fl in flats],
                            axis=0).astype(flats[0][k].dtype)
                 for k in keys}
    save_checkpoint(native_path(out_path), _nest(mean_flat))
    return len(mean_flat)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.average_checkpoints",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("checkpoints", nargs="+",
                        help="two or more native .npz checkpoints")
    parser.add_argument("--out", required=True, help="output checkpoint path")
    args = parser.parse_args(argv)
    n = average_checkpoints(args.checkpoints, args.out)
    print(f"averaged {len(args.checkpoints)} checkpoints "
          f"({n} arrays) -> {args.out}")


if __name__ == "__main__":
    main()
