"""Evaluation bar plots (reference eval_plots.py surface).

``barh_multiple_plots`` renders horizontal per-class bars for
tp/fp/fn/gt/pred counters. Matplotlib is imported lazily so headless /
TPU-pod environments without a display never pay for it.

Framework-neutral copy of ``yolov3_tpu/eval/plots.py`` (the port imports nothing of the
JAX package). tests/test_torch_eval.py pins it to its original.
"""

from __future__ import annotations

import numpy as np


def barh_multiple_plots(values_list, labels, class_names, title="evaluation", out_path=None):
    """values_list: list of (nclasses,) arrays; labels: one name per array."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nclasses = len(class_names)
    height = 0.8 / max(len(values_list), 1)
    y = np.arange(nclasses, dtype=np.float64)
    fig, ax = plt.subplots(figsize=(10, max(4, nclasses * 0.5)))
    for i, (vals, label) in enumerate(zip(values_list, labels)):
        ax.barh(y + i * height, np.asarray(vals), height=height, label=label)
    ax.set_yticks(y + 0.4)
    ax.set_yticklabels(class_names)
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path)
    return fig
