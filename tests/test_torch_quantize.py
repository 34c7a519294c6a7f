"""The port's post-training quantization (yolov3_tpu_torch/ops/quantize.py,
ops/s2d.py, models/convert.py::qparams_*) against the JAX package's, on the
CPU, on the synthetic spec of tests/test_torch_layers_network.py at 32 px.

Tolerance: calibration absmax 1e-4 relative (it comes from the fp forward,
which the two libraries sum in different orders); given the SAME absmax,
quantized kernels, scales and biases bit-equal; the stem rewrite exact."""

import os

import jax
import numpy as np
import pytest
import torch

from yolov3_tpu.models import network as jnet
from yolov3_tpu.models.spec import parse_model_config as jax_parse
from yolov3_tpu.ops import quantize as jquant
from yolov3_tpu.ops import s2d as js2d
from yolov3_tpu_torch.models import network as tnet
from yolov3_tpu_torch.models.convert import params_from_jax, qparams_from_jax, qparams_to_jax
from yolov3_tpu_torch.models.spec import parse_model_config
from yolov3_tpu_torch.ops import quantize as tquant
from yolov3_tpu_torch.ops import s2d as ts2d

from .conftest import REPO
from .test_torch_layers_network import SYNTHETIC, _random_bn, _spec_fields

SIZE = 32


@pytest.fixture(scope="module")
def folded(tmp_path_factory):
    path = tmp_path_factory.mktemp("int8") / "model.yaml"
    path.write_text(SYNTHETIC)
    jspec, tspec = jax_parse(str(path), 2), parse_model_config(str(path), 2)
    jp, js = _random_bn(*jnet.init_model(jax.random.PRNGKey(3), jspec), 3)
    tp, ts = params_from_jax(jp, js)
    calib = [np.random.RandomState(0).rand(4, SIZE, SIZE, 3).astype(np.float32)]
    # one set of folded weights for both sides (each library's own fold is
    # 1 ulp apart, tests/test_torch_layers_network.py holds that to 1e-6)
    jf = jax.tree.map(np.asarray, jnet.fold_batch_norm(jp, js))
    tf, _ = params_from_jax(jf, {})
    absmax = jquant.calibrate_scales(jspec, jf, calib)
    return jspec, tspec, jf, tf, calib, absmax


def _assert_trees_equal(got, want):
    flat_g, tree_g = jax.tree.flatten(got)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("model_file", ["config/models/yolov3/model.yaml",
                                        "config/models/yolov3_spp/model.yaml",
                                        "config/models/yolov3_tiny/model.yaml"])
def test_head_taps_and_skip_sets_match_jax(model_file):
    path = os.path.join(REPO, model_file)
    jspec, tspec = jax_parse(path, 80), parse_model_config(path, 80)
    taps = tquant.head_conv_taps(tspec)
    assert taps == jquant.head_conv_taps(jspec) and taps
    for kwargs in ({}, {"skip_final_convs": False}, {"min_k2cin": 300},
                   {"skip_final_convs": False, "min_k2cin": 1200}):
        assert (tquant.quantized_conv_skips(tspec, **kwargs)
                == jquant.quantized_conv_skips(jspec, **kwargs))


def test_calibrate_scales_matches_jax(folded):
    jspec, tspec, _, tf, calib, (jin, jout) = folded
    tin, tout = tquant.calibrate_scales(tspec, tf, calib)
    assert set(tin) == set(jin) and set(tout) == set(jout)
    for got, want in ((tin, jin), (tout, jout)):
        for key in want:
            assert isinstance(got[key], float)
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=0)
    assert tquant.calibrate_activation_scales(tspec, tf, calib) == tin


@pytest.mark.parametrize("chain,min_k2cin", [(False, 0), (True, 0), (True, 50)])
def test_quantize_params_matches_jax_given_the_same_absmax(folded, chain, min_k2cin):
    jspec, tspec, jf, tf, _, (jin, jout) = folded
    kwargs = dict(out_absmax=jout if chain else None, min_k2cin=min_k2cin)
    want = jax.tree.map(np.asarray, jquant.quantize_params(jspec, jf, jin, **kwargs))
    got = tquant.quantize_params(tspec, tf, jin, **kwargs)
    backbone = got["backbone"]
    assert backbone["layer2"]["kernel_q"].dtype == torch.int8
    assert tuple(backbone["layer2"]["kernel_q"].shape) == (16, 3, 3, 8)  # (cout, kh, kw, cin)
    assert backbone["layer2"]["in_scale"].dtype == torch.float32
    assert ("out_scale" in backbone["layer2"]) == chain
    assert ("layer5" in backbone) == chain  # the shortcut's out_scale entry
    assert ("kernel_q" in backbone["layer1"]) == (min_k2cin == 0)  # 3·3·3 = 27 < 50
    assert "kernel" in got["head0"]["layer0"]  # final head conv stays fp
    _assert_trees_equal(qparams_to_jax(got), want)
    _assert_trees_equal(qparams_to_jax(qparams_from_jax(want)), want)


def test_quantized_scales_keep_the_f64_quotient_then_one_rounding():
    """absmax/127 is taken in f64 and cast once, as jnp.float32(absmax/127.0)."""
    absmax = 3.4028234e+00
    want = np.float32(absmax / 127.0)
    assert tquant._scale(absmax, "cpu").numpy() == want
    assert tquant._scale(absmax, "cpu").dtype == torch.float32


def test_s2d_stem_matches_jax_and_is_bit_exact(folded):
    jspec, tspec, jf, tf, _, (jin, jout) = folded
    jq = jquant.quantize_params(jspec, jf, jin, out_absmax=jout)
    tq = qparams_from_jax(jax.tree.map(np.asarray, jq))
    jspec2, jq2 = js2d.s2d_stem(jspec, jq, image_size=SIZE)
    tspec2, tq2 = ts2d.s2d_stem(tspec, tq, image_size=SIZE)
    assert tspec2 is not tspec and _spec_fields(tspec2) == _spec_fields(jspec2)
    l0, l1 = tspec2.sub_models[0].layers[1:3]
    assert (l0["size"], l0["stride"], l0["filters"]) == (4, 2, 32)
    assert l0["explicit_pad"] == ((1, 2), (1, 2)) and l1["explicit_pad"] == ((1, 0), (1, 0))
    _assert_trees_equal(qparams_to_jax(tq2), jax.tree.map(np.asarray, jq2))
    images = torch.from_numpy(np.random.RandomState(1).rand(2, SIZE, SIZE, 3)
                              .astype(np.float32))
    plain = tnet.apply_model(tspec, tq, {}, images)
    rewritten = tnet.apply_model(tspec2, tq2, {}, images)
    for a, b in zip(plain, rewritten):
        assert torch.equal(a, b)


def test_s2d_stem_is_a_no_op_where_it_does_not_apply(folded):
    jspec, tspec, jf, tf, _, (jin, jout) = folded
    tq = tquant.quantize_params(tspec, tf, jin)
    assert ts2d.s2d_stem(tspec, tq, image_size=33) == (tspec, tq)        # odd size
    assert ts2d.s2d_stem(tspec, tf, image_size=SIZE) == (tspec, tf)      # fp stem
    mixed = tquant.quantize_params(tspec, tf, jin, min_k2cin=50)         # conv0 left in fp
    assert ts2d.s2d_stem(tspec, mixed, image_size=SIZE) == (tspec, mixed)
    tiny = os.path.join(REPO, "config/models/yolov3_tiny/model.yaml")
    tiny_spec = parse_model_config(tiny, 3)
    assert ts2d._find_stem(tiny_spec.sub_models[0]) is None              # maxpool stem
    assert (ts2d._find_stem(tspec.sub_models[0])
            == js2d._find_stem(jspec.sub_models[0]) == 1)
