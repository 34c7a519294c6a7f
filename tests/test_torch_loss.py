"""The port's loss (yolov3_tpu_torch/ops/loss.py) against the JAX package's,
on the CPU: the four terms per scale and the gradient w.r.t. the logits.
Inputs come from numpy seeds.

Tolerance: terms 1e-4 relative — XLA:CPU's ``log`` and ``exp`` are
approximate (~1e-5 relative, see tests/test_loss.py), so the two f32 results
cannot be held closer; measured here 2e-6 to 3e-5. Gradients 1e-4 of the
largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops import loss as jloss
from yolov3_tpu.ops.assign import assign_targets as jax_assign
from yolov3_tpu_torch.ops import loss as tloss

ANCHORS = np.array([[0.28, 0.22], [0.38, 0.48], [0.90, 0.78],
                    [0.07, 0.15], [0.15, 0.11], [0.14, 0.29]], np.float32).reshape(2, 3, 2)
NC = 4
TERM_RTOL = 1e-4


def _case(seed, b=3, grids=(4, 8), logit_scale=2.0):
    rng = np.random.RandomState(seed)
    labels = np.zeros((b, 8, 6), np.float32)
    for i in range(b):
        for j in range(5):
            w, h = rng.rand(2) * rng.choice([0.1, 0.6]) + 0.02
            x0, y0 = rng.rand() * (1 - w), rng.rand() * (1 - h)
            labels[i, j] = [x0, y0, x0 + w, y0 + h, 1, rng.randint(NC)]
    y_true = [np.array(t) for t in jax_assign(jnp.asarray(labels), ANCHORS, grids)]
    y_pred = [(rng.randn(b, g, g, 3, 5 + NC) * logit_scale).astype(np.float32) for g in grids]
    return y_true, y_pred


@pytest.mark.parametrize("seed,logit_scale", [(0, 2.0), (1, 0.1), (2, 12.0)])
def test_loss_terms_match_jax(seed, logit_scale):
    """logit_scale 12 drives sigmoids into the Keras epsilon clip on both sides."""
    y_true, y_pred = _case(seed, logit_scale=logit_scale)
    for s, (t, p) in enumerate(zip(y_true, y_pred)):
        want = np.asarray(jloss.yolo_loss_terms(jnp.asarray(t), jnp.asarray(p), ANCHORS[s], NC))
        got = tloss.yolo_loss_terms(torch.from_numpy(t), torch.from_numpy(p), ANCHORS[s], NC)
        assert got.dtype == torch.float32 and tuple(got.shape) == (4,)
        assert np.isfinite(want).all() and (want > 0).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=TERM_RTOL)


def test_make_loss_fn_matrix_matches_jax():
    y_true, y_pred = _case(3)
    want = np.asarray(jloss.make_loss_fn(ANCHORS, NC)([jnp.asarray(t) for t in y_true],
                                                      [jnp.asarray(p) for p in y_pred]))
    got = tloss.make_loss_fn(ANCHORS, NC)([torch.from_numpy(t) for t in y_true],
                                          [torch.from_numpy(p) for p in y_pred])
    assert tuple(got.shape) == (2, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=TERM_RTOL)


@pytest.mark.parametrize("seed,logit_scale", [(4, 2.0), (5, 12.0)])
def test_gradient_wrt_logits_matches_jax(seed, logit_scale):
    y_true, y_pred = _case(seed, logit_scale=logit_scale)
    t, p = y_true[1], y_pred[1]
    jgrad = np.asarray(jax.grad(lambda q: jnp.sum(jloss.yolo_loss_terms(
        jnp.asarray(t), q, ANCHORS[1], NC)))(jnp.asarray(p)))
    pt = torch.from_numpy(p).requires_grad_(True)
    tloss.yolo_loss_terms(torch.from_numpy(t), pt, ANCHORS[1], NC).sum().backward()
    np.testing.assert_allclose(pt.grad.numpy(), jgrad, rtol=0,
                               atol=1e-4 * float(np.abs(jgrad).max()))


def test_bf16_heads_are_computed_in_f32():
    """The loss casts to f32 first: bf16 heads give the f32 loss of the
    bf16-rounded logits, on both sides."""
    y_true, y_pred = _case(6)
    t, p = y_true[0], y_pred[0]
    p_bf16 = torch.from_numpy(p).to(torch.bfloat16)
    got = tloss.yolo_loss_terms(torch.from_numpy(t), p_bf16, ANCHORS[0], NC)
    want = np.asarray(jloss.yolo_loss_terms(jnp.asarray(t), jnp.asarray(p, jnp.bfloat16),
                                            ANCHORS[0], NC))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TERM_RTOL)


def test_padded_targets_give_no_nan():
    """All-zero targets: wh = 0 → log(0) = −inf → 0; only the objectness term
    is non-zero."""
    p = np.random.RandomState(8).randn(2, 4, 4, 3, 5 + NC).astype(np.float32)
    t = np.zeros((2, 4, 4, 3, 6), np.float32)
    got = tloss.yolo_loss_terms(torch.from_numpy(t), torch.from_numpy(p), ANCHORS[0], NC)
    want = np.asarray(jloss.yolo_loss_terms(jnp.asarray(t), jnp.asarray(p), ANCHORS[0], NC))
    assert torch.isfinite(got).all() and float(got[0]) == float(got[1]) == float(got[3]) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=TERM_RTOL)
