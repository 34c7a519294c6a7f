"""The port's checkpoint tools against the JAX package's, on the CPU.

  * ``tools/average_checkpoints.py``: bit-equal to the JAX tool's output on
    three seeded checkpoints; mismatched key sets and fewer than two
    checkpoints raise ``ValueError``.
  * ``tools/bn_recalibrate.py``: ``recalibrate`` against the JAX tool's
    ``recalibrate`` on YOLOv3-tiny at 96 px with one and two batches, within
    2e-4 (rtol and atol: the JAX package's own tolerance for the tool,
    tests/test_bn_recalibrate.py; the division by 1 − m = 0.01 magnifies the
    rounding of the EMA 100×). In the port one batch is a fixed point of the
    train-mode EMA and two batches give the mean of the two single-batch
    results. The command line with ``--device cpu`` on the bundled trained
    tiny: params byte-identical, statistics moved and within 2e-4 of JAX's
    ``recalibrate`` on the same batch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.average_checkpoints import average_checkpoints as jax_average
from tools.bn_recalibrate import recalibrate as jax_recalibrate
from yolov3_tpu.data.tfrecord import parse_tfrecords as jax_parse_tfrecords
from yolov3_tpu.io.resolve import load_weights as jax_load_weights
from yolov3_tpu.io.resolve import save_weights as jax_save_weights
from yolov3_tpu.models import init_model as jax_init
from yolov3_tpu.models import parse_model_config as jax_parse
from yolov3_tpu_torch.io.checkpoint import _flatten, load_checkpoint, save_checkpoint
from yolov3_tpu_torch.io.resolve import load_weights, native_path
from yolov3_tpu_torch.models import apply_model, init_model, parse_model_config
from yolov3_tpu_torch.models.convert import params_from_jax, params_to_jax
from yolov3_tpu_torch.models.layers import BN_MOMENTUM
from yolov3_tpu_torch.tools import bn_recalibrate
from yolov3_tpu_torch.tools.average_checkpoints import average_checkpoints
from yolov3_tpu_torch.tree import tree_leaves, tree_map

from .conftest import REPO
from .test_torch_data import native_decode_tier
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

TINY = os.path.join(REPO, "config/models/yolov3_tiny/model.yaml")
TRAINED_TINY = os.path.join(REPO, "checkpoints/output/yolov3_train_tiny.tf")
SHAPES = os.path.join(REPO, "datasets/shapes_toy")
TOL = 2e-4


def _flat(path):
    return _flatten(load_checkpoint(native_path(str(path)))[0])


def test_average_bit_equal_to_jax(tmp_path):
    spec = jax_parse(TINY, 3)
    paths = []
    for seed in range(3):
        params, state = jax_init(jax.random.PRNGKey(seed), spec)
        state = jax.tree.map(lambda x, s=seed: x + 0.25 * s, state)
        paths.append(str(tmp_path / f"c{seed}.tf"))
        jax_save_weights(spec, params, state, paths[-1])
    n_jax = jax_average(paths, str(tmp_path / "jax_avg.tf"))
    n_port = average_checkpoints(paths, str(tmp_path / "port_avg.tf"))
    got, want = _flat(tmp_path / "port_avg.tf"), _flat(tmp_path / "jax_avg.tf")
    assert n_port == n_jax == len(want) and set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the JAX loader reads it like any checkpoint
    p0, s0 = jax_init(jax.random.PRNGKey(9), spec)
    jax_load_weights(spec, p0, s0, str(tmp_path / "port_avg.tf"))


def test_average_rejects_mismatched_keys_and_single_checkpoint(tmp_path):
    spec = jax_parse(TINY, 3)
    params, state = jax_init(jax.random.PRNGKey(0), spec)
    a = str(tmp_path / "a.tf")
    jax_save_weights(spec, params, state, a)
    tree, _ = load_checkpoint(native_path(a))
    tree.pop(sorted(tree)[0])
    c = str(tmp_path / "c.tf.npz")
    save_checkpoint(c, tree)
    with pytest.raises(ValueError, match="key set differs"):
        average_checkpoints([a, c], str(tmp_path / "bad.tf"))
    with pytest.raises(ValueError, match="at least two"):
        average_checkpoints([a], str(tmp_path / "one.tf"))


def _tiny_pair(seed=0):
    """The same seeded weights in both packages: (JAX spec, params, state),
    (port spec, params, state)."""
    jspec = jax_parse(TINY, 3)
    jparams, jstate = jax_init(jax.random.PRNGKey(seed), jspec)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params, state = params_from_jax(np_tree(jparams), np_tree(jstate))
    return (jspec, jparams, jstate), (parse_model_config(TINY, 3), params, state)


def _assert_state_close(port_state, jax_state):
    _, want = params_to_jax({}, port_state)
    got_leaves = jax.tree.leaves(want)
    want_leaves = jax.tree.leaves(jax.tree.map(np.asarray, jax_state))
    assert len(got_leaves) == len(want_leaves) > 0
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("nbatches", [1, 2])
def test_recalibrate_matches_jax(nbatches):
    (jspec, jparams, jstate), (spec, params, state) = _tiny_pair()
    rng = np.random.RandomState(3)
    batches = [rng.rand(4, 96, 96, 3).astype(np.float32) for _ in range(nbatches)]
    got, n = bn_recalibrate.recalibrate(spec, params, state, batches, BN_MOMENTUM,
                                        device="cpu")
    want, n_jax = jax_recalibrate(jspec, jparams, jstate, batches, BN_MOMENTUM)
    assert n == n_jax == nbatches
    _assert_state_close(got, want)


def test_recalibrate_single_batch_fixed_point_and_two_batch_mean():
    _, (spec, params, state) = _tiny_pair()
    rng = np.random.RandomState(4)
    b1, b2 = (rng.rand(4, 96, 96, 3).astype(np.float32) for _ in range(2))
    s1, _ = bn_recalibrate.recalibrate(spec, params, state, [b1], BN_MOMENTUM, device="cpu")
    with torch.no_grad():
        _, after = apply_model(spec, params, s1, torch.from_numpy(b1), train=True)
    for a, b in zip(tree_leaves(s1), tree_leaves(after)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)

    s2, _ = bn_recalibrate.recalibrate(spec, params, state, [b2], BN_MOMENTUM, device="cpu")
    s12, n = bn_recalibrate.recalibrate(spec, params, state, [b1, b2], BN_MOMENTUM,
                                        device="cpu")
    assert n == 2
    mean = tree_map(lambda a, b: (a + b) / 2, s1, s2)
    for a, b in zip(tree_leaves(s12), tree_leaves(mean)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_recalibrate_without_batches_raises():
    _, (spec, params, state) = _tiny_pair()
    with pytest.raises(ValueError, match="no calibration batches"):
        bn_recalibrate.recalibrate(spec, params, state, [], BN_MOMENTUM, device="cpu")


def test_cli_on_trained_tiny(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(REPO)  # the tool resolves paths against the repo root
    out = str(tmp_path / "recal.tf")
    with native_decode_tier():
        _recalibrate_both(out, capsys)


def _recalibrate_both(out, capsys):
    """The port's tool on the trained tiny, then JAX's ``recalibrate`` on
    the batch that JAX's reader decodes from the same TFRecords."""
    bn_recalibrate.main(["--ckpt", TRAINED_TINY, "--model_config", TINY,
                         "--data_root", SHAPES, "--image_size", "96", "--batches", "1",
                         "--batch_size", "8", "--out", out, "--device", "cpu"])
    assert '"batches": 1' in capsys.readouterr().out

    before, after = _flat(TRAINED_TINY), _flat(out)
    assert set(before) == set(after)
    params_keys = [k for k in before if k.startswith("params/")]
    state_keys = [k for k in before if k.startswith("bn_state/")]
    assert params_keys and state_keys
    for key in params_keys:
        assert before[key].tobytes() == after[key].tobytes(), key
    assert any(not np.allclose(before[k], after[k]) for k in state_keys)

    # JAX's recalibrate on the same batch of the same weights
    jspec = jax_parse(TINY, 3)
    jparams, jstate = jax_load_weights(jspec, *jax_init(jax.random.PRNGKey(0), jspec),
                                       TRAINED_TINY)
    batch = []
    for im, _ in jax_parse_tfrecords(os.path.join(SHAPES, "tfrecords/train"), 96, 10,
                                     os.path.join(SHAPES, "class.names")):
        batch.append(np.asarray(im))
        if len(batch) == 8:
            break
    want, _ = jax_recalibrate(jspec, jparams, jstate, [jnp.asarray(np.stack(batch))],
                              BN_MOMENTUM)
    want_flat = _flatten({"bn_state": jax.tree.map(np.asarray, want)})
    for key in state_keys:
        np.testing.assert_allclose(after[key], want_flat[key], rtol=TOL, atol=TOL,
                                   err_msg=key)
    spec = parse_model_config(TINY, 3)  # and the port loads it back
    _, port_state = load_weights(spec, *init_model(spec, torch.Generator().manual_seed(0)), out)
    assert all(torch.isfinite(t).all() for t in tree_leaves(port_state))
