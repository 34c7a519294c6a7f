"""Per-class evaluation bar charts (the reference's eval_plots.py).

Counterpart of the JAX package's root ``eval_plots.py``, with the same
command line: loads the ``.npy`` counter histograms that ``evaluate`` writes
into its working directory (``tp_<threshold>.npy``, ``fp_``, ``fn_``,
``gts_``, ``preds_``), sums each over its images and renders tp/fp/fn/gt/pred
bars per class through the port's ``eval/plots.py``. A host tool: it touches
no device.

Usage (from the directory that holds the ``.npy`` files):
  python -m yolov3_tpu_torch.tools.eval_plots --classes_name_file <names>
      [--threshold 0.1] [--out eval_plot.png]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import read_class_names
from ..eval.plots import barh_multiple_plots

COUNTERS = ("tp", "fp", "fn", "gts", "preds")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.eval_plots")
    parser.add_argument("--threshold", type=str, default="0.1",
                        help="score threshold suffix of the .npy files")
    parser.add_argument("--classes_name_file", type=str, required=True)
    parser.add_argument("--out", type=str, default="eval_plot.png")
    args = parser.parse_args(argv)

    class_names = read_class_names(args.classes_name_file)
    values = [np.load(f"{name}_{args.threshold}.npy").sum(axis=0) for name in COUNTERS]
    barh_multiple_plots(values, list(COUNTERS), class_names,
                        title=f"evaluation @ score>{args.threshold}", out_path=args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
