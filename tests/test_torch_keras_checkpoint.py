"""The port's Keras TF-format checkpoint reader
(yolov3_tpu_torch/io/checkpoint.py::load_tf_keras_checkpoint, through
io/resolve.py and tools/convert_tf_checkpoint.py) against the JAX package's,
on the CPU. The fixture is the JAX test's synthetic Keras-object-graph
checkpoint (tests/test_convert_tf_checkpoint.py).

  * the port's reader gives trees bit-equal to JAX's reader (HWIO kernels
    become OIHW) and the same count of loaded variables, in full and for a
    checkpoint that holds only the backbone (expect_partial: the rest keeps
    the template's values);
  * ``load_weights(prefix)`` reads the ``.index`` checkpoint;
  * the port's converter tool writes arrays bit-equal to the JAX tool's, and
    exits when no variable matched;
  * with the TensorFlow import made to fail, the reader raises
    ``ImportError`` naming the port's converter tool.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from .conftest import REPO, has_tf

pytestmark = pytest.mark.skipif(not has_tf(), reason="tensorflow unavailable")

from tools import convert_tf_checkpoint as jax_tool  # noqa: E402
from yolov3_tpu.io.checkpoint import load_tf_keras_checkpoint as jax_reader  # noqa: E402
from yolov3_tpu.models import init_model as jax_init  # noqa: E402
from yolov3_tpu.models import parse_model_config as jax_parse  # noqa: E402
from yolov3_tpu_torch.io.checkpoint import (_flatten, load_checkpoint,  # noqa: E402
                                            load_tf_keras_checkpoint)
from yolov3_tpu_torch.io.resolve import load_weights  # noqa: E402
from yolov3_tpu_torch.models import init_model, parse_model_config  # noqa: E402
from yolov3_tpu_torch.models.convert import params_to_jax  # noqa: E402
from yolov3_tpu_torch.tools import convert_tf_checkpoint  # noqa: E402

from .test_convert_tf_checkpoint import _write_keras_style_tf_checkpoint  # noqa: E402

TINY = os.path.join(REPO, "config/models/yolov3_tiny/model.yaml")
NCLASSES = 7


@pytest.fixture()
def keras_ckpt(tmp_path):
    """(JAX spec, source params, source state, checkpoint prefix)."""
    jspec = jax_parse(TINY, NCLASSES)
    params, state = jax_init(jax.random.PRNGKey(42), jspec)
    state = jax.tree.map(lambda x: x + 0.25, state)
    prefix = str(tmp_path / "yolov3_train_tiny.tf")
    _write_keras_style_tf_checkpoint(jspec, params, state, prefix)
    return jspec, params, state, prefix


def _port_template():
    spec = parse_model_config(TINY, NCLASSES)
    return spec, *init_model(spec, torch.Generator().manual_seed(0))


def _assert_bit_equal(port_params, port_state, jax_params, jax_state):
    got = _flatten(dict(zip(("params", "bn_state"), params_to_jax(port_params, port_state))))
    want = _flatten({"params": jax.tree.map(np.asarray, jax_params),
                     "bn_state": jax.tree.map(np.asarray, jax_state)})
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_reader_bit_equal_to_jax(keras_ckpt):
    jspec, src_params, src_state, prefix = keras_ckpt
    jp, js, jax_loaded = jax_reader(jspec, *jax_init(jax.random.PRNGKey(0), jspec), prefix)
    spec, params, state = _port_template()
    params, state, loaded = load_tf_keras_checkpoint(spec, params, state, prefix)
    assert loaded == jax_loaded == len(jax.tree.leaves((src_params, src_state)))
    _assert_bit_equal(params, state, jp, js)
    _assert_bit_equal(*load_weights(spec, *_port_template()[1:], prefix), src_params, src_state)


def test_partial_checkpoint_keeps_template_values(tmp_path):
    jspec = jax_parse(TINY, NCLASSES)
    params, state = jax_init(jax.random.PRNGKey(3), jspec)
    backbone = jspec.sub_models[0]
    partial = type(jspec)(sub_models=(backbone,), output_stage=jspec.output_stage,
                          decay_factor=jspec.decay_factor, grid_sizes=jspec.grid_sizes,
                          nclasses=jspec.nclasses)
    prefix = str(tmp_path / "backbone.tf")
    _write_keras_style_tf_checkpoint(partial, params, state, prefix)

    jp, js, jax_loaded = jax_reader(jspec, *jax_init(jax.random.PRNGKey(0), jspec), prefix)
    spec, tp, ts = _port_template()
    template = params_to_jax(tp, ts)
    p, s, loaded = load_tf_keras_checkpoint(spec, tp, ts, prefix)
    assert 0 < loaded == jax_loaded
    got_p, got_s = params_to_jax(p, s)
    for key, entry in got_p.items():
        want = jp[key] if key == backbone.name else template[0][key]
        for a, b in zip(jax.tree.leaves(entry), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_converter_tool_bit_equal_to_jax(keras_ckpt, tmp_path, capsys):
    _, _, _, prefix = keras_ckpt
    args = ["--model-config", TINY, "--nclasses", str(NCLASSES), "--input", prefix]
    jax_tool.main(args + ["--output", str(tmp_path / "jax.npz")])
    convert_tf_checkpoint.main(args + ["--output", str(tmp_path / "port.npz")])
    assert "variables)" in capsys.readouterr().out
    got = _flatten(load_checkpoint(str(tmp_path / "port.npz"))[0])
    want = _flatten(load_checkpoint(str(tmp_path / "jax.npz"))[0])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    import tensorflow as tf

    unrelated = tf.train.Checkpoint(x=tf.Variable(1.0)).write(str(tmp_path / "other.tf"))
    with pytest.raises(SystemExit, match="matched no variables"):
        convert_tf_checkpoint.main(["--model-config", TINY, "--nclasses", str(NCLASSES),
                                    "--input", unrelated, "--output", str(tmp_path / "x.npz")])
    with pytest.raises(SystemExit):  # exactly one of --classes-name-file / --nclasses
        convert_tf_checkpoint.main(["--model-config", TINY, "--input", prefix])


def test_reader_without_tensorflow_raises(keras_ckpt, monkeypatch):
    _, _, _, prefix = keras_ckpt
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    spec, params, state = _port_template()
    with pytest.raises(ImportError, match="yolov3_tpu_torch.tools.convert_tf_checkpoint"):
        load_tf_keras_checkpoint(spec, params, state, prefix)
    with pytest.raises(ImportError, match="requires tensorflow"):
        load_weights(spec, params, state, prefix)
