"""``python -m yolov3_tpu_torch.apps.cli convert`` (apps/convert_app.py)
against the JAX package's ``convert_app.convert``, on the CPU.

  * ``convert --device cpu`` on a YOLOv3-tiny ``.weights`` file writes an
    ``.npz`` whose arrays are bit-equal to the JAX converter's output for the
    same file, and which the JAX package's ``load_weights`` reads;
  * a ``.weights`` file with a NaN in a kernel fails the sanity forward with
    ``ValueError`` on both sides, and neither writes a checkpoint;
  * without ``--device`` on a machine with no card, the command raises.

Tolerance: none — the checkpoint carries the file's bits.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.apps.convert_app import convert as jax_convert
from yolov3_tpu.io.darknet import save_darknet_weights as jax_save
from yolov3_tpu.io.resolve import load_weights as jax_load_weights
from yolov3_tpu.models import init_model as jax_init
from yolov3_tpu.models import parse_model_config as jax_parse
from yolov3_tpu_torch.apps import cli
from yolov3_tpu_torch.io.checkpoint import _flatten, load_checkpoint

from .conftest import REPO
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

TINY = os.path.join(REPO, "config/models/yolov3_tiny/model.yaml")


def _weights_file(tmp_path, nan=False):
    spec = jax_parse(TINY, 3)
    params, state = jax_init(jax.random.PRNGKey(7), spec)
    state = jax.tree.map(lambda x: x + 0.25, state)
    if nan:
        first = sorted(params["backbone"])[0]
        k = np.array(params["backbone"][first]["kernel"])
        k[0, 0, 0, 0] = np.nan
        params["backbone"][first]["kernel"] = k
    path = str(tmp_path / ("nan.weights" if nan else "tiny.weights"))
    jax_save(spec, params, state, path)
    return path


def _config(tmp_path, weights_file, out_name):
    cfg = dict(num_classes=3, weights_file=weights_file, model_config_file=TINY,
               output_weights_file=str(tmp_path / out_name))
    path = tmp_path / f"{out_name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, str(path)


def test_convert_cli_bit_equal_to_jax(tmp_path, capsys):
    weights = _weights_file(tmp_path)
    jcfg, _ = _config(tmp_path, weights, "jax.tf")
    jax_convert(jcfg)
    _, port_yaml = _config(tmp_path, weights, "port.tf")
    cli.main(["convert", "--config", port_yaml, "--device", "cpu"])
    assert "sanity check passed" in capsys.readouterr().out

    got = _flatten(load_checkpoint(str(tmp_path / "port.tf.npz"))[0])
    want = _flatten(load_checkpoint(str(tmp_path / "jax.tf.npz"))[0])
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    spec = jax_parse(TINY, 3)
    p0, s0 = jax_init(jax.random.PRNGKey(0), spec)
    p1, s1 = jax_load_weights(spec, p0, s0, str(tmp_path / "port.tf"))
    for a, b in zip(jax.tree.leaves((p1, s1)),
                    jax.tree.leaves(jax_load_weights(spec, p0, s0, str(tmp_path / "jax.tf")))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_nan_kernel_fails_the_sanity_forward_on_both_sides(tmp_path):
    weights = _weights_file(tmp_path, nan=True)
    jcfg, _ = _config(tmp_path, weights, "jax.tf")
    with pytest.raises(ValueError, match="sanity check failed"):
        jax_convert(jcfg)
    _, port_yaml = _config(tmp_path, weights, "port.tf")
    with pytest.raises(ValueError, match="sanity check failed"):
        cli.convert_main(["--config", port_yaml, "--device", "cpu"])
    assert not os.path.exists(tmp_path / "jax.tf.npz")
    assert not os.path.exists(tmp_path / "port.tf.npz")


def test_convert_without_card_raises_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, port_yaml = _config(tmp_path, _weights_file(tmp_path), "port.tf")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["convert", "--config", port_yaml])
    assert not os.path.exists(tmp_path / "port.tf.npz")
