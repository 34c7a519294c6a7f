"""Darknet ``.weights`` import and export of the port
(yolov3_tpu_torch/io/darknet.py) against the JAX package's
(yolov3_tpu/io/darknet.py), on the CPU.

  * a file written by JAX's ``save_darknet_weights`` from a seeded JAX init
    (BN state + 0.25) loads in the port bit-equal to ``params_from_jax`` of
    the JAX trees;
  * the port's ``save_darknet_weights`` of those params writes the same bytes;
  * for yolov3_tiny, yolov3_spp (1 class) and the canonical tiny Darknet
    ``.cfg`` of tests/test_darknet_cfg.py;
  * a truncated file and a file with floats left over raise ``ValueError``;
  * the port's forward on the loaded params is bit-equal to its forward on
    ``params_from_jax``, and within 1e-4 of the JAX forward (the heads'
    tolerance of the port's other tests).
"""

import os

import jax
import numpy as np
import pytest
import torch

from yolov3_tpu.io.darknet import save_darknet_weights as jax_save
from yolov3_tpu.models import apply_model as jax_apply
from yolov3_tpu.models import init_model as jax_init
from yolov3_tpu.models import parse_model_config as jax_parse
from yolov3_tpu_torch.io.darknet import load_darknet_weights, save_darknet_weights
from yolov3_tpu_torch.models import apply_model, parse_model_config
from yolov3_tpu_torch.models.convert import params_from_jax, params_to_jax
from yolov3_tpu_torch.tree import tree_leaves

from .conftest import REPO
from .test_darknet_cfg import TINY_CFG

HEAD_TOL = 1e-4


def _model_file(tmp_path, name):
    if name == "tiny_cfg":
        path = tmp_path / "yolov3-tiny.cfg"
        path.write_text(TINY_CFG)
        return str(path), 80
    return os.path.join(REPO, f"config/models/{name}/model.yaml"), 1 if name == "yolov3_spp" else 3


def _jax_weights(tmp_path, name, seed=5):
    """(port spec, JAX params, JAX state + 0.25, path of JAX's .weights file)."""
    model_file, nclasses = _model_file(tmp_path, name)
    jspec = jax_parse(model_file, nclasses)
    params, state = jax_init(jax.random.PRNGKey(seed), jspec)
    state = jax.tree.map(lambda x: x + 0.25, state)
    path = str(tmp_path / f"{name}.weights")
    jax_save(jspec, params, state, path)
    return parse_model_config(model_file, nclasses), jspec, params, state, path


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", ["yolov3_tiny", "yolov3_spp", "tiny_cfg"])
def test_load_bit_equal_and_save_byte_identical(tmp_path, name):
    spec, _, jparams, jstate, path = _jax_weights(tmp_path, name)
    want_p, want_s = params_from_jax(_np_tree(jparams), _np_tree(jstate))
    got_p, got_s = load_darknet_weights(spec, path)
    for got, want in ((got_p, want_p), (got_s, want_s)):
        assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
            jax.tree.structure(jax.tree.map(lambda t: 0, want))
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    out = str(tmp_path / "port.weights")
    save_darknet_weights(spec, got_p, got_s, out)
    with open(out, "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()


def test_truncated_and_leftover_files_raise(tmp_path):
    spec, _, _, _, path = _jax_weights(tmp_path, "yolov3_tiny")
    with open(path, "rb") as f:
        data = f.read()
    for cut, match in ((12, "header"), (len(data) // 2, "truncated"), (len(data) - 4, "kernel")):
        bad = str(tmp_path / f"cut{cut}.weights")
        with open(bad, "wb") as f:
            f.write(data[:cut])
        with pytest.raises(ValueError, match=match):
            load_darknet_weights(spec, bad)
    extra = str(tmp_path / "extra.weights")
    with open(extra, "wb") as f:
        f.write(data + np.zeros(3, np.float32).tobytes())
    with pytest.raises(ValueError, match="3 floats left"):
        load_darknet_weights(spec, extra)


@pytest.mark.parametrize("name", ["yolov3_tiny", "tiny_cfg"])
def test_forward_on_loaded_params(tmp_path, name):
    spec, jspec, jparams, jstate, path = _jax_weights(tmp_path, name)
    params, state = load_darknet_weights(spec, path)
    ref_p, ref_s = params_from_jax(*params_to_jax(params, state))
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    with torch.inference_mode():
        got = apply_model(spec, params, state, torch.from_numpy(x))
        same = apply_model(spec, ref_p, ref_s, torch.from_numpy(x))
    want = jax_apply(jspec, jparams, jstate, x)[0]
    assert len(got) == len(want) == 2
    for g, s, w in zip(got, same, want):
        assert torch.equal(g, s)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=HEAD_TOL)
