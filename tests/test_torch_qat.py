"""The port's quantization-aware training (yolov3_tpu_torch/ops/quantize.py
fake_quant_*, make_activation_fake_quant; parallel/train_step.py ``qat``;
apps/train_app.py parse_qat_*) against the JAX package's, on the CPU.

Tolerances:
  * fake-quant forward of kernels (OIHW here, HWIO there) and activations,
    f32 and bf16, against the JAX functions jitted (as the JAX train step runs
    them: XLA turns their ``/ 127.0`` into a product with f32(1/127)): the
    integers round(x / scale) and the fake-quantized values bit-equal;
  * the straight-through gradient: exactly the identity;
  * the skip sets (which convs stay fp) identical;
  * one training forward and backward with ``qat`` weights / activations /
    full on YOLOv3-tiny at 96 px, B=4: the tolerances of
    tests/test_torch_train_step.py (metrics 1e-5 relative, floor 1e-4; new
    BN state 1e-5; gradient leaves within 2e-4 of the leaf's largest entry);
    L2 regularization bit-for-bit the fp run's (it reads the masters). With
    activation QAT the step is held in two halves, see
    ``test_one_activation_qat_step_matches_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.apps import train_app as japp
from yolov3_tpu.models.spec import parse_model_config as jax_parse
from yolov3_tpu.ops import quantize as jquant
from yolov3_tpu.parallel import train_step as jts
from yolov3_tpu_torch.apps import train_app as tapp
from yolov3_tpu_torch.models.convert import params_from_jax, params_to_jax
from yolov3_tpu_torch.models.spec import parse_model_config
from yolov3_tpu_torch.ops import quantize as tquant
from yolov3_tpu_torch.parallel import train_step as tts

from .conftest import REPO
from .test_torch_train_extras import MINI
from .test_torch_train_step import (ANCHORS, BATCH, GRAD_TOL, _assert_trees_close, _np,
                                    make_setup, setup)  # noqa: F401  (setup is a fixture)
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)


@pytest.fixture(scope="module")
def mini_setup(tmp_path_factory):
    """The setup of tests/test_torch_train_step.py on a model with no
    max-pooling (``MINI``: stride-2 convs)."""
    path = tmp_path_factory.mktemp("mini") / "mini.yaml"
    path.write_text(MINI)
    return make_setup(str(path))


def _kernel(seed, shape=(3, 3, 16, 8), dtype=np.float32):
    rng = np.random.RandomState(seed)
    k = rng.randn(*shape).astype(np.float32) * rng.rand(1, 1, 1, shape[-1]).astype(np.float32)
    k[..., 0] = 0.0  # an all-zero output channel: the 1e-12 floor of its scale
    # values on exact half-steps of the lattice: round half to even decides
    k[0, 0, 0, 1] = 127.0 * 0.25
    k[1, 1, 1, 1] = -127.0 * 0.25
    k[2, 2, 2, 1] = 2.5 * 0.25
    k[0, 1, 2, 1] = 3.5 * 0.25
    return k.astype(dtype)


@jax.jit
def _jax_integers(k_hwio):
    k32 = jnp.asarray(k_hwio, jnp.float32)
    w_scale = jnp.maximum(jnp.max(jnp.abs(k32), axis=(0, 1, 2)), 1e-12) / 127.0
    return jnp.round(k32 / w_scale)


def _port_integers(k_oihw):
    k32 = k_oihw.to(torch.float32)
    w_scale = torch.clamp(k32.abs().amax(dim=(1, 2, 3), keepdim=True),
                          min=1e-12) * tquant._INV_127
    return torch.round(k32 / w_scale).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_kernel_bit_equal(dtype):
    k = _kernel(0)
    jk = jnp.asarray(k, dtype)
    tk = torch.from_numpy(k).permute(3, 2, 0, 1).to(getattr(torch, dtype))  # HWIO → OIHW
    np.testing.assert_array_equal(_port_integers(tk).transpose(2, 3, 1, 0),
                                  np.asarray(_jax_integers(jk.astype(jnp.float32))))
    want = np.asarray(jax.jit(jquant.fake_quant_kernel)(jk).astype(jnp.float32))
    got = tquant.fake_quant_kernel(tk)
    assert got.dtype == tk.dtype
    np.testing.assert_array_equal(got.to(torch.float32).numpy().transpose(2, 3, 1, 0), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_activation_bit_equal(dtype):
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 8, 6, 5) * 3.0).astype(np.float32)
    x[0, 0, 0, 0] = 12.7   # absmax: scale 0.1, so 0.05-steps sit on half-way points
    x[1, 1, 1, 1:5] = [0.05, 0.15, -0.25, 0.35]
    jx = jnp.asarray(x.transpose(0, 2, 3, 1), dtype)   # NHWC there, NCHW here
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jax.jit(jquant.fake_quant_activation)(jx).astype(jnp.float32))
    want = want.transpose(0, 3, 1, 2)
    got = tquant.fake_quant_activation(tx)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    x32 = tx.to(torch.float32)
    scale = torch.clamp(x32.abs().amax(), min=1e-12) * tquant._INV_127
    ints = torch.round(x32 / scale).numpy()
    jints = np.asarray(jax.jit(lambda v: jnp.round(
        v / (jnp.maximum(jnp.max(jnp.abs(v)), 1e-12) / 127.0)))(jnp.asarray(jx, jnp.float32)))
    np.testing.assert_array_equal(ints, jints.transpose(0, 3, 1, 2))


def test_straight_through_gradient_is_the_identity():
    k = torch.from_numpy(_kernel(2)).permute(3, 2, 0, 1).contiguous().requires_grad_(True)
    x = torch.randn(2, 16, 5, 5, generator=torch.Generator().manual_seed(0), requires_grad=True)
    gk, gx = torch.randn(k.shape), torch.randn(x.shape)
    (tquant.fake_quant_kernel(k) * gk).sum().backward()
    (tquant.fake_quant_activation(x) * gx).sum().backward()
    assert torch.equal(k.grad, gk) and torch.equal(x.grad, gx)


@pytest.mark.parametrize("model_file,min_k2cin", [("config/models/yolov3/model.yaml", 0),
                                                  ("config/models/yolov3/model.yaml", 300),
                                                  ("config/models/yolov3_tiny/model.yaml", 200)])
def test_fake_quant_trees_skip_the_convs_jax_skips(model_file, min_k2cin):
    path = f"{REPO}/{model_file}"
    jspec, tspec = jax_parse(path, 3), parse_model_config(path, 3)
    params = {sm.name: {f"layer{i}": {"kernel": torch.ones(2, 2, 1, 1)}
                        for i, layer in enumerate(sm.layers) if layer.kind == "convolutional"}
              for sm in tspec.sub_models}
    out = tquant.fake_quant_weights(tspec, params, min_k2cin=min_k2cin)
    kept = {(sm, key) for sm, entries in out.items() for key, e in entries.items()
            if e is params[sm][key]}
    assert kept == jquant.quantized_conv_skips(jspec, min_k2cin=min_k2cin)
    transform = tquant.make_activation_fake_quant(tspec, min_k2cin=min_k2cin)
    x = torch.tensor([[[[0.3]], [[1.0]]]])
    passed = {(sm, key) for sm, entries in params.items() for key in entries
              if transform(sm, key, x) is x}
    assert passed == kept


@pytest.mark.parametrize("conf", [False, None, True, "weights", "full", " Activations ",
                                  {"weights": True}, {"activations": True},
                                  {"weights": False, "activations": True},
                                  {"weights": False}, {"activations": True, "min_k2cin": 300}])
def test_qat_config_parses_as_jax(conf):
    assert tapp.parse_qat_mode(conf) == japp.parse_qat_mode(conf)
    assert tapp.parse_qat_min_k2cin(conf) == japp.parse_qat_min_k2cin(conf)


def test_qat_config_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="qat must be true") as port_err:
        tapp.parse_qat_mode("int4")
    with pytest.raises(ValueError) as jax_err:
        japp.parse_qat_mode("int4")
    assert str(port_err.value) == str(jax_err.value)


def _jax_qat_step(s, mode, monkeypatch):
    """JAX's jitted forward + backward with ``qat=mode``; with activation QAT
    it also returns, for every conv, the input the step's transform saw and
    what it returned (recorded inside the same traced step)."""
    record = {}
    original = jquant.make_activation_fake_quant

    def recording(spec, **kwargs):
        transform = original(spec, **kwargs)

        def wrapped(sm_name, key, x):
            y = transform(sm_name, key, x)
            record[(sm_name, key)] = (x, y)
            return y
        return wrapped

    monkeypatch.setattr(jquant, "make_activation_fake_quant", recording)

    def loss(p, bn, images, labels):
        record.clear()
        total, (new_bn, metrics) = jts._loss_and_metrics(
            s["jspec"], p, bn, images, labels, jnp.asarray(ANCHORS), s["grids"], BATCH, (),
            True, qat=mode)
        return total, (new_bn, metrics, dict(record))

    @jax.jit
    def fn(params, bn, images, labels):
        (_, (new_bn, metrics, taps)), grads = jax.value_and_grad(
            lambda p: loss(p, bn, images, labels), has_aux=True)(params)
        return grads, new_bn, metrics, taps

    out = _np(fn(s["jp"], s["js"], s["images"], s["labels"]))
    monkeypatch.undo()
    return out


def _port_step(s, mode):
    grads, new_bn, metrics = tts.loss_and_grads(
        s["tspec"], s["tp"], s["ts"], torch.from_numpy(s["images"]),
        torch.from_numpy(s["labels"]), ANCHORS, s["grids"], BATCH, qat=mode)
    g, bn = params_to_jax(grads, new_bn)
    return g, bn, {k: v.numpy() for k, v in metrics.items()}


def _assert_step_matches(port, jgrads, jbn, jm):
    g, bn, tm = port
    _assert_trees_close(tm, jm, rtol=1e-5, atol=1e-4)
    _assert_trees_close(bn, jbn, rtol=1e-5, atol=1e-6)
    _assert_trees_close(g, jgrads, rtol=0, atol=None, scale_by_leaf_max=GRAD_TOL)


@pytest.mark.parametrize("model", ["tiny", "mini"])
def test_one_weight_qat_step_matches_jax(setup, mini_setup, monkeypatch, model):  # noqa: F811
    s = setup if model == "tiny" else mini_setup
    jgrads, jbn, jm, taps = _jax_qat_step(s, "weights", monkeypatch)
    assert not taps
    port = _port_step(s, "weights")
    _assert_step_matches(port, jgrads, jbn, jm)
    # the loss did move off the fp run's, and L2 still reads the masters
    _, _, fp = _port_step(s, False)
    assert float(port[2]["total_loss"]) != float(fp["total_loss"])
    assert float(port[2]["regularization"]) == float(fp["regularization"])


@pytest.mark.parametrize("model,mode", [("tiny", "activations"), ("mini", "activations"),
                                        ("mini", "full")])
def test_one_activation_qat_step_matches_jax(setup, mini_setup, monkeypatch, model,
                                             mode):  # noqa: F811
    """Activation QAT is discontinuous: a conv input that moves by an ulp
    (the two libraries' f32 convolutions) moves its absmax, so the lattice
    scale, and flips lattice points downstream. So the step is held in two
    halves: (1) on every conv input the JAX step's transform saw, the port's
    transform returns the same bits; (2) the port's step, its transform
    returning those JAX bits (straight-through from its own input), matches
    the JAX step at the fp tolerances above. ``full`` runs on ``MINI`` only:
    with weights and inputs both on lattices a conv's outputs come in
    near-ties that ulps apart decide, and a max-pool (tiny has six) routes
    its gradient to whichever of them wins."""
    s = setup if model == "tiny" else mini_setup
    jgrads, jbn, jm, taps = _jax_qat_step(s, mode, monkeypatch)
    skips = jquant.quantized_conv_skips(s["jspec"])
    assert set(taps) == {(sm.name, f"layer{i}") for sm in s["jspec"].sub_models
                         for i, layer in enumerate(sm.layers)
                         if layer.kind == "convolutional"}
    for (sm_name, key), (x, y) in taps.items():
        got = tquant.make_activation_fake_quant(s["tspec"])(
            sm_name, key, torch.from_numpy(np.array(x)).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), y,
                                      err_msg=f"{sm_name}/{key}")
        assert ((sm_name, key) in skips) == bool(np.array_equal(x, y))

    def substituting(spec, **kwargs):
        def transform(sm_name, key, x):
            y = torch.from_numpy(np.array(taps[(sm_name, key)][1])).permute(0, 3, 1, 2)
            return x + (y - x).detach()
        return transform

    monkeypatch.setattr(tts, "make_activation_fake_quant", substituting)
    _assert_step_matches(_port_step(s, mode), jgrads, jbn, jm)


def test_qat_weights_tree_round_trips_through_the_port_layout(setup):  # noqa: F811
    """fake_quant_weights over the whole tiny model, both packages, the
    port's tree carried back to the JAX layout: bit-equal."""
    s = setup
    want = _np(jax.jit(lambda p: jquant.fake_quant_weights(s["jspec"], p))(
        jax.tree.map(jnp.asarray, s["jp"])))
    got, _ = params_to_jax(tquant.fake_quant_weights(s["tspec"], s["tp"]), {})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert params_from_jax(want, {})[0].keys() == s["tp"].keys()
