"""The port's target assignment (yolov3_tpu_torch/ops/assign.py) against the
JAX package's, on the CPU. Labels come from numpy seeds.

Tolerance: none — anchor indices and every target cube bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops import assign as jassign
from yolov3_tpu_torch.ops import assign as tassign

ANCHORS = np.array([[0.28, 0.22], [0.38, 0.48], [0.90, 0.78],
                    [0.07, 0.15], [0.15, 0.11], [0.14, 0.29],
                    [0.02, 0.03], [0.04, 0.07], [0.08, 0.06]], np.float32).reshape(3, 3, 2)
GRIDS = (4, 8, 16)


def _random_labels(seed, b=4, m=12, boxes=9, nc=5):
    rng = np.random.RandomState(seed)
    labels = np.zeros((b, m, 6), np.float32)
    for i in range(b):
        for j in range(boxes):
            w, h = rng.rand(2) * rng.choice([0.05, 0.2, 0.8]) + 0.01
            x0, y0 = rng.rand() * (1 - w), rng.rand() * (1 - h)
            labels[i, j] = [x0, y0, x0 + w, y0 + h, 1, rng.randint(nc)]
    return labels


def _compare(labels, anchors=ANCHORS, grids=GRIDS):
    want = jassign.assign_targets(jnp.asarray(labels), anchors, grids)
    got = tassign.assign_targets(torch.from_numpy(labels), anchors, grids)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_assign_targets_bit_equal(seed):
    labels = _random_labels(seed)
    got = _compare(labels)
    assert sum(float(g[..., 4].sum()) for g in got) > 0


@pytest.mark.parametrize("seed", [0, 5])
def test_best_anchor_indices_equal(seed):
    labels = _random_labels(seed, boxes=12)
    want = np.asarray(jassign.best_anchor_indices(jnp.asarray(labels), ANCHORS))
    got = tassign.best_anchor_indices(torch.from_numpy(labels), ANCHORS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_argmax_takes_the_first_maximum():
    """Two identical anchors tie exactly; the lower index must win on both sides."""
    anchors = ANCHORS.copy()
    anchors[1, 0] = anchors[0, 2]  # flattened anchor 3 == anchor 2
    labels = np.zeros((1, 4, 6), np.float32)
    labels[0, 0] = [0.05, 0.1, 0.95, 0.88, 1, 0]  # exactly the tied anchors' size class
    want = np.asarray(jassign.best_anchor_indices(jnp.asarray(labels), anchors))
    got = tassign.best_anchor_indices(torch.from_numpy(labels), anchors).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 2
    _compare(labels, anchors)


def test_duplicate_slot_goes_to_the_highest_label_index():
    labels = np.zeros((2, 6, 6), np.float32)
    # three boxes of one size in one cell of image 0: same (cell, anchor) slot
    labels[0, 0] = [0.30, 0.30, 0.50, 0.50, 1, 1]
    labels[0, 2] = [0.31, 0.31, 0.51, 0.51, 1, 2]
    labels[0, 4] = [0.305, 0.305, 0.505, 0.505, 1, 3]
    labels[1, 1] = [0.30, 0.30, 0.50, 0.50, 1, 4]
    got = _compare(labels)
    hit = [g for g in got if float(g[0, ..., 4].sum()) > 0]
    assert len(hit) == 1 and float(hit[0][0, ..., 4].sum()) == 1.0
    assert float(hit[0][0, ..., 5].max()) == 3.0  # label row 4, the last, won


def test_padded_rows_and_zero_objectness_are_dropped():
    labels = _random_labels(7, boxes=3)
    labels[:, 1, 4] = 0.0  # a full box row with obj == 0
    got = _compare(labels)
    assert sum(float(g[..., 4].sum()) for g in got) == 4 * 2
    empty = np.zeros((2, 5, 6), np.float32)  # nothing but padding: 0/0-free, all-zero cubes
    for cube in _compare(empty):
        assert not cube.any()


def test_centre_at_exactly_one_lands_in_the_last_cell():
    labels = np.zeros((1, 3, 6), np.float32)
    labels[0, 0] = [0.9, 0.9, 1.1, 1.1, 1, 2]    # centre (1.0, 1.0)
    labels[0, 1] = [-0.1, -0.1, 0.1, 0.1, 1, 1]  # centre (0.0, 0.0)
    got = _compare(labels)
    for cube in got:
        if float(cube[..., 4].sum()):
            g = cube.shape[1]
            assert float(cube[0, g - 1, g - 1, :, 4].sum()) == 1.0
            assert float(cube[0, 0, 0, :, 4].sum()) == 1.0


def test_real_anchor_table_and_grids(repo_root):
    """The shapes_toy anchors with YOLOv3's grids at 416 and B=16 shapes."""
    import os

    from yolov3_tpu_torch.config import get_anchors

    anchors = get_anchors(os.path.join(repo_root, "datasets/shapes_toy/anchors/anchors.txt"))
    _compare(_random_labels(9, b=3, m=100, boxes=20, nc=3), anchors, (13, 26, 52))
