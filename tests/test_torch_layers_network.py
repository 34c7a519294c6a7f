"""The port's model stack (yolov3_tpu_torch/models/, io/, config.py) against
the JAX package's, on the CPU in float32.

  * forward parity per head on a tiny synthetic spec that holds every layer
    kind of YOLOv3 (stride-2 conv, shortcut, two-source route, upsample,
    asymmetric SAME maxpool, yolo), and on yolov3_tiny at 96 px with the
    in-repo trained checkpoint;
  * fold_batch_norm, the HWIO↔OIHW weight carry, native checkpoints both ways;
  * the framework-neutral copies (spec parsers, config helpers) parse every
    bundled model family to the same specification as their originals.

Tolerance: heads 1e-4 absolute (two libraries' float32 convolutions sum in
different orders); weight transforms 1e-6; everything else exact."""

import os

import jax
import numpy as np
import pytest
import torch

from yolov3_tpu import config as jconfig
from yolov3_tpu.io.resolve import load_weights as jax_load_weights
from yolov3_tpu.models import network as jnet
from yolov3_tpu.models.darknet_cfg import write_darknet_cfg
from yolov3_tpu.models.spec import parse_model_config as jax_parse
from yolov3_tpu_torch import config as tconfig
from yolov3_tpu_torch.device import resolve_device
from yolov3_tpu_torch.io.resolve import load_weights, save_weights
from yolov3_tpu_torch.models import network as tnet
from yolov3_tpu_torch.models.convert import params_from_jax, params_to_jax
from yolov3_tpu_torch.models.spec import parse_model_config

from .conftest import REPO
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

HEAD_TOL = 1e-4

SYNTHETIC = """
output_stage: head
sub_models_configs:
- name: backbone
  layers_config:
  - {type: route, source: {inputs: [0]}}
  - {type: convolutional, filters: 8, size: 3, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: 16, size: 3, stride: 2, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: 8, size: 1, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: 16, size: 3, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: shortcut, from: -3, activation: linear}
  - {type: maxpool, size_xy: [2, 2], stride_xy: [1, 1], padding: same}
  - {type: convolutional, filters: 32, size: 3, stride: 2, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: maxpool, size_xy: [2, 2], stride_xy: [2, 2], padding: same}
  outputs_layers: [6, -1]
- name: head0
  inputs:
    source:
    - {name: backbone, entry_index: 1}
  layers_config:
  - {type: convolutional, filters: '3*(5+nclasses)', size: 1, stride: 1, pad: 1, activation: linear}
  - {type: yolo}
  outputs_layers: [-1]
- name: head1
  inputs:
    source:
    - {name: backbone, entry_index: 1}
    - {name: backbone, entry_index: 0}
  layers_config:
  - {type: route, source: {inputs: [0]}}
  - {type: convolutional, filters: 8, size: 1, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: upsample, stride: 4}
  - {type: route, source: {layers: [-1], inputs: [1]}}
  - {type: convolutional, filters: 16, size: 3, stride: 1, pad: 1, activation: leaky, batch_normalize: 1}
  - {type: convolutional, filters: '3*(5+nclasses)', size: 1, stride: 1, pad: 1, activation: linear}
  - {type: yolo}
  outputs_layers: [-1]
"""


def _random_bn(params, state, seed):
    """Non-trivial BN statistics and biases (numpy, JAX layout)."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    for sm, entries in params.items():
        for key, e in entries.items():
            c = e["kernel"].shape[-1]
            if "bn" in e:
                e["bn"] = {"gamma": (rng.rand(c) + 0.5).astype(np.float32),
                           "beta": (rng.randn(c) * 0.1).astype(np.float32)}
                state[sm][key] = {"mean": (rng.randn(c) * 0.1).astype(np.float32),
                                  "var": (rng.rand(c) + 0.5).astype(np.float32)}
            else:
                e["bias"] = (rng.randn(c) * 0.1).astype(np.float32)
    return params, state


def _synthetic(tmp_path, nc=2):
    path = tmp_path / "model.yaml"
    path.write_text(SYNTHETIC)
    return str(path), nc


def _compare_heads(jax_outs, torch_outs):
    assert len(jax_outs) == len(torch_outs)
    for j, t in zip(jax_outs, torch_outs):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=HEAD_TOL)


@pytest.mark.parametrize("fold", [False, True])
def test_synthetic_forward_matches_jax(tmp_path, fold):
    path, nc = _synthetic(tmp_path)
    jspec, tspec = jax_parse(path, nc), parse_model_config(path, nc)
    jp, js = jnet.init_model(jax.random.PRNGKey(3), jspec)
    jp, js = _random_bn(jp, js, 3)
    tp, ts = params_from_jax(jp, js)
    if fold:
        jp, js = jnet.fold_batch_norm(jp, js), {}
        tp, ts = tnet.fold_batch_norm(tp, ts), {}
    images = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    jouts, _ = jnet.apply_model(jspec, jp, js, images)
    touts = tnet.apply_model(tspec, tp, ts, torch.from_numpy(images))
    assert [tuple(o.shape) for o in touts] == [(2, 4, 4, 3, 7), (2, 16, 16, 3, 7)]
    _compare_heads(jouts, touts)


def _tiny(repo_root):
    names = os.path.join(repo_root, "datasets/shapes_toy/class.names")
    return (os.path.join(repo_root, "config/models/yolov3_tiny/model.yaml"),
            len(tconfig.read_class_names(names)),
            os.path.join(repo_root, "checkpoints/output/yolov3_train_tiny.tf"))


def test_tiny_checkpoint_forward_matches_jax(repo_root):
    """yolov3_tiny at 96 px with the trained in-repo checkpoint, loaded by
    each package's own loader from the one .npz, BN folded as served."""
    model, nc, ckpt = _tiny(repo_root)
    jspec, tspec = jax_parse(model, nc), parse_model_config(model, nc)
    jp, js = jnet.init_model(jax.random.PRNGKey(0), jspec)
    jp, js = jax_load_weights(jspec, jp, js, ckpt)
    tp, ts = tnet.init_model(tspec, torch.Generator().manual_seed(0))
    tp, ts = load_weights(tspec, tp, ts, ckpt)
    images = np.random.RandomState(1).rand(2, 96, 96, 3).astype(np.float32)
    jouts, _ = jnet.apply_model(jspec, jnet.fold_batch_norm(jp, js), {}, images)
    touts = tnet.apply_model(tspec, tnet.fold_batch_norm(tp, ts), {},
                             torch.from_numpy(images))
    _compare_heads(jouts, touts)
    assert tnet.param_count(tp) == jnet.param_count(jp)
    assert tnet.head_grid_sizes(tspec, 96) == jnet.head_grid_sizes(jspec, 96) == (3, 6)


def test_fold_batch_norm_matches_jax(tmp_path):
    path, nc = _synthetic(tmp_path)
    jspec = jax_parse(path, nc)
    jp, js = _random_bn(*jnet.init_model(jax.random.PRNGKey(5), jspec), 5)
    tp, ts = params_from_jax(jp, js)
    want = jax.tree.map(np.asarray, jnet.fold_batch_norm(jp, js))
    got, _ = params_to_jax(tnet.fold_batch_norm(tp, ts), {})
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_w == tree_g
    for w, g in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_weight_layout_round_trip(tmp_path):
    """HWIO → OIHW → HWIO is the identity, OIHW really is PyTorch's layout
    (a 1-pixel conv agrees with the HWIO matmul), and a checkpoint the port
    saves is read back identically by the JAX package's loader."""
    path, nc = _synthetic(tmp_path)
    jspec, tspec = jax_parse(path, nc), parse_model_config(path, nc)
    jp, js = _random_bn(*jnet.init_model(jax.random.PRNGKey(7), jspec), 7)
    tp, ts = params_from_jax(jp, js)
    back_p, back_s = params_to_jax(tp, ts)
    for a, b in zip(jax.tree.leaves((jp, js)), jax.tree.leaves((back_p, back_s))):
        np.testing.assert_array_equal(np.asarray(a), b)

    k_hwio = np.asarray(jp["backbone"]["layer3"]["kernel"])  # 1×1, 16 → 8
    x = np.random.RandomState(0).rand(16).astype(np.float32)
    conv = torch.nn.functional.conv2d(torch.from_numpy(x).view(1, 16, 1, 1),
                                      tp["backbone"]["layer3"]["kernel"])
    np.testing.assert_allclose(conv.view(-1).numpy(), x @ k_hwio[0, 0], atol=1e-6)

    ckpt = str(tmp_path / "port_ckpt")
    save_weights(tspec, tp, ts, ckpt)
    zp, zs = jnet.init_model(jax.random.PRNGKey(0), jspec)
    lp, ls = jax_load_weights(jspec, zp, zs, ckpt)
    for a, b in zip(jax.tree.leaves((jp, js)), jax.tree.leaves((lp, ls))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _spec_fields(spec):
    return (tuple((sm.name, tuple((l.kind, l.attrs) for l in sm.layers), sm.inputs,
                   sm.outputs_layers, sm.input_shape) for sm in spec.sub_models),
            spec.output_stage, spec.decay_factor, spec.grid_sizes, spec.nclasses)


MODEL_FILES = ["config/models/yolov3/model.yaml", "config/models/yolov3/model_thin_heads.yaml",
               "config/models/yolov3_spp/model.yaml", "config/models/yolov3_tiny/model.yaml",
               "config/models/yolov3_tiny/yolov3_tiny.yaml"]


@pytest.mark.parametrize("model_file", MODEL_FILES)
def test_neutral_spec_copies_parse_like_originals(repo_root, model_file, tmp_path):
    path = os.path.join(repo_root, model_file)
    jspec = jax_parse(path, 80)
    assert _spec_fields(parse_model_config(path, 80)) == _spec_fields(jspec)
    cfg = write_darknet_cfg(jspec, str(tmp_path / "m.cfg"))  # Darknet .cfg route
    assert _spec_fields(parse_model_config(cfg, 80)) == _spec_fields(jax_parse(cfg, 80))


def test_neutral_config_copies_match_originals():
    anchors = os.path.join(REPO, "datasets/coco2012/anchors.txt")
    names = os.path.join(REPO, "datasets/coco2012/coco.names")
    np.testing.assert_array_equal(tconfig.get_anchors(anchors), jconfig.get_anchors(anchors))
    assert tconfig.read_class_names(names) == jconfig.read_class_names(names)
    images = os.path.join(REPO, "datasets/shapes_toy/coco/images")
    assert tconfig.dir_filelist(images, (".jpg",)) == jconfig.dir_filelist(images, (".jpg",))
    for expr in ("3*(2+2+1+nclasses)", "(None, None, 3)", "2**3 - 7 // 2"):
        assert (tconfig.safe_eval_expr(expr, {"nclasses": 80})
                == jconfig.safe_eval_expr(expr, {"nclasses": 80}))
    assert tconfig.load_yaml(os.path.join(REPO, "config/serve_config.yaml")) == \
        jconfig.load_yaml(os.path.join(REPO, "config/serve_config.yaml"))


def test_device_defaults_to_the_card():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
