"""The trainer's extensions in the port (yolov3_tpu_torch) against the JAX
package, on the CPU: BatchNorm over space-to-depth phase groups and from a
spatial subsample (models/layers.py), the training stem rewrite
(ops/s2d.py::s2d_stem_train, the phase kernels), the train step with each,
the multi-scale size schedules and device downscale, and whole ``Train``
runs with the keys together.

Tolerances:
  * ``batch_norm`` with ``phases=4`` and/or ``stats_subsample=2``: output
    and new state 1e-5;
  * ``s2d_stem_train``'s spec: equal, field for field; the phase kernels:
    equal;
  * one train step with ``stem_s2d`` or ``bn_stats_subsample`` against
    JAX's: the tolerances of tests/test_torch_train_step.py (metrics 1e-5
    relative, floor 1e-4; BN state 1e-5; gradient leaves 2e-4 of the leaf
    max); with both, the stem's gradients against float64 instead (see
    ``test_one_step_with_stem_s2d_and_subsample``); the ``stem_s2d`` step
    against the port's un-rewritten one: loss 1e-4 relative, gradient leaves
    2e-4 of the leaf max, BN state 1e-5;
  * ``ms_size_for`` / ``ms_size_for_step``: identical sequences;
  * the device downscale against ``jax.image.resize(…, "bilinear")``: 1e-5;
  * a whole ``Train`` run (qat weights, stem_s2d, bn_stats_subsample,
    multi_scale by epoch, device_dataset) against JAX's ``Train`` on the
    shapes_toy TFRecords at 64–96 px, 2 epochs: per-epoch train and val
    losses 1e-3 relative;
  * ``Train`` with augmentation (which draws differently by design) and the
    remaining keys: runs, finite, writes its files."""

import ast
import glob
import os
import re
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.apps import train_app as japp
from yolov3_tpu.io.resolve import save_weights as jax_save_weights
from yolov3_tpu.models import network as jnet
from yolov3_tpu.models import layers as jlayers
from yolov3_tpu.models.spec import parse_model_config as jax_parse
from yolov3_tpu.ops import s2d as js2d
from yolov3_tpu.parallel import train_step as jts
from yolov3_tpu_torch.apps import train_app as tapp
from yolov3_tpu_torch.models import layers as tlayers
from yolov3_tpu_torch.models.convert import params_to_jax
from yolov3_tpu_torch.models.spec import parse_model_config
from yolov3_tpu_torch.ops import s2d as ts2d
from yolov3_tpu_torch.ops.image import resize_antialiased
from yolov3_tpu_torch.parallel import train_step as tts
from yolov3_tpu_torch.tree import tree_map

from .conftest import REPO
from .test_torch_data import native_decode_tier
from .test_torch_layers_network import SYNTHETIC, _spec_fields
from .test_torch_train_app import _captured_logs, _config
from .test_torch_train_step import (ANCHORS, BATCH, GRAD_TOL, _assert_trees_close, _np,
                                    make_setup)

# a small detector with the Darknet stem (3×3 s1, then 3×3 s2) and no
# max-pooling: stride-2 convs down to /32, two heads (/32 and /16)
MINI = """
backbone:
  [
    [-1, 1, Conv, [8, 3, 1, 1, 1, 1]],
    [-1, 1, Conv, [16, 3, 2, 1, 1, 1]],
    [-1, 1, Conv, [16, 3, 2, 1, 1, 1]],
    [-1, 1, Conv, [32, 3, 2, 1, 1, 1]],
    [-1, 1, Conv, [32, 3, 2, 1, 1, 1]],
    [-1, 1, Conv, [64, 3, 2, 1, 1, 1]],
  ]
head:
  [
    [-1, 1, Conv, [32, 1, 1, 1, 1, 1]],
    [-1, 1, Conv, [64, 3, 1, 1, 1, 1]],
    [-1, 1, Conv, ['na*(nc+5)', 1, 1, 1, 0, 0]],
    [-1, 1, Reshape, [13, 13, 'na', '(nc+5)']],
    [6, 1, Conv, [16, 1, 1, 1, 1, 1]],
    [-1, 1, Upsample, [2]],
    [[-1, 4], 1, Concat, []],
    [-1, 1, Conv, [32, 3, 1, 1, 1, 1]],
    [-1, 1, Conv, ['na*(nc+5)', 1, 1, 1, 0, 0]],
    [-1, 1, Reshape, [26, 26, 'na', '(nc+5)']],
    [[9, -1], 1, Output, ['nc']],
  ]
"""


@pytest.fixture(scope="module")
def mini_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("mini") / "mini.yaml"
    path.write_text(MINI)
    return str(path)


@pytest.fixture(scope="module")
def mini(mini_file):
    return make_setup(mini_file)


@pytest.fixture
def jax_subsample():
    """Sets the JAX package's process-wide BN-statistics subsample for one
    test, and puts it back to 1."""
    yield jlayers.set_bn_stats_subsample
    jlayers.set_bn_stats_subsample(1)


# --- BatchNorm over phase groups and from a subsample ---

def _bn_inputs(seed, phases, b=3, c=5, h=12, w=10):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, h, w, phases * c) * 2.0 + rng.randn(phases * c)).astype(np.float32)
    params = {"gamma": (rng.rand(c) + 0.5).astype(np.float32),
              "beta": rng.randn(c).astype(np.float32)}
    state = {"mean": rng.randn(c).astype(np.float32), "var": (rng.rand(c) + 0.5).astype(np.float32)}
    return x, params, state


@pytest.mark.parametrize("phases,subsample,train,layout", [
    (4, 1, True, "nchw"), (4, 1, True, "channels_last"), (1, 2, True, "nchw"),
    (1, 2, True, "channels_last"), (4, 2, True, "channels_last"), (4, 1, False, "nchw")])
def test_batch_norm_phases_and_subsample_match_jax(jax_subsample, phases, subsample, train,
                                                   layout):
    x, params, state = _bn_inputs(phases * 10 + subsample, phases)
    jax_subsample(subsample)
    jy, jstate = jax.jit(lambda v: jlayers.batch_norm(
        v, params, state, train, phases=phases))(jnp.asarray(x))
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=fmt)
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    ty, tstate = tlayers.batch_norm(tx, to_t(params), to_t(state), train, phases=phases,
                                    stats_subsample=subsample)
    np.testing.assert_allclose(ty.permute(0, 2, 3, 1).numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_phase_view_is_a_view_and_its_gradient_reshapes_back(layout):
    """The statistics of the phase groups are taken through a view of the
    activation (same storage, no copy) in either memory layout, and the
    gradient through them reaches x in x's shape and memory format, equal to
    plain autograd on the (B, P, C, H, W) split within 1e-6."""
    x, params, state = _bn_inputs(7, 4)
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    base = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=fmt)
    view = tlayers._phase_view(base, 4)
    assert view.data_ptr() == base.data_ptr() and view._base is not None
    assert view.shape[1] == 5 and view.numel() == base.numel()

    xg = base.clone().requires_grad_(True)
    mean, var = tlayers.bn_moments(tlayers._phase_view(xg, 4))
    weights = torch.randn(2, 5, generator=torch.Generator().manual_seed(0))
    ((mean * weights[0]).sum() + (var * weights[1]).sum()).backward()
    assert xg.grad.shape == xg.shape and xg.grad.stride() == xg.stride()

    ref = base.clone().requires_grad_(True)
    split = ref.reshape(3, 4, 5, 12, 10)
    m = split.mean(dim=(0, 1, 3, 4))
    v = (split * split).mean(dim=(0, 1, 3, 4)) - m * m
    ((m * weights[0]).sum() + (v * weights[1]).sum()).backward()
    torch.testing.assert_close(xg.grad, ref.grad, rtol=0, atol=1e-6)


def test_subsample_copy_is_dense_in_the_same_format():
    x = torch.randn(2, 6, 9, 8).contiguous(memory_format=torch.channels_last)
    sub = tlayers._subsampled(x, 2)
    assert sub.shape == (2, 6, 5, 4) and sub.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(sub, x[:, :, ::2, ::2])
    assert tlayers._subsampled(x.contiguous(), 2).is_contiguous()
    with pytest.raises(ValueError, match="phase view"):
        tlayers._phase_view(x[:, :, ::2], 2)


# --- the training stem rewrite ---

@pytest.mark.parametrize("model", ["mini", "synthetic", "config/models/yolov3/model.yaml",
                                   "config/models/yolov3_tiny/model.yaml"])
@pytest.mark.parametrize("size", [None, 96, 97])
def test_s2d_stem_train_spec_equals_jax(tmp_path, model, size):
    if model in ("mini", "synthetic"):
        path = tmp_path / "m.yaml"
        path.write_text(MINI if model == "mini" else SYNTHETIC)
        path = str(path)
    else:
        path = f"{REPO}/{model}"
    jspec, tspec = jax_parse(path, 3), parse_model_config(path, 3)
    jout, tout = js2d.s2d_stem_train(jspec, size), ts2d.s2d_stem_train(tspec, size)
    assert _spec_fields(tout) == _spec_fields(jout)
    assert (tout is tspec) == (jout is jspec)
    rewrites = "tiny" not in model and size != 97
    assert (tout is not tspec) == rewrites


def test_s2d_phase_kernels_equal_jax():
    k = np.random.RandomState(3).randn(3, 3, 5, 7).astype(np.float32)   # HWIO
    tk = torch.from_numpy(k).permute(3, 2, 0, 1)                          # OIHW
    for jfn, tfn in ((jlayers.s2d_phase_kernel_conv0, tlayers.s2d_phase_kernel_conv0),
                     (jlayers.s2d_phase_kernel_conv1, tlayers.s2d_phase_kernel_conv1)):
        np.testing.assert_array_equal(tfn(tk).permute(2, 3, 1, 0).numpy(),
                                      np.asarray(jfn(jnp.asarray(k))))


def _jax_step(s, spec):
    @jax.jit
    def fn(params, bn, images, labels):
        (_, (new_bn, metrics)), grads = jax.value_and_grad(
            lambda p: jts._loss_and_metrics(spec, p, bn, images, labels, jnp.asarray(ANCHORS),
                                            s["grids"], BATCH, (), True),
            has_aux=True)(params)
        return grads, new_bn, metrics
    return _np(fn(s["jp"], s["js"], s["images"], s["labels"]))


def _port_step(s, spec, **kwargs):
    grads, new_bn, metrics = tts.loss_and_grads(
        spec, s["tp"], s["ts"], torch.from_numpy(s["images"]), torch.from_numpy(s["labels"]),
        ANCHORS, s["grids"], BATCH, **kwargs)
    g, bn = params_to_jax(grads, new_bn)
    return g, bn, {k: v.numpy() for k, v in metrics.items()}


@pytest.mark.parametrize("stem_s2d,subsample", [(True, 1), (False, 2)])
def test_one_step_matches_jax(mini, jax_subsample, stem_s2d, subsample):
    s = mini
    jspec = js2d.s2d_stem_train(s["jspec"]) if stem_s2d else s["jspec"]
    tspec = ts2d.s2d_stem_train(s["tspec"]) if stem_s2d else s["tspec"]
    assert (tspec is not s["tspec"]) == stem_s2d
    jax_subsample(subsample)
    jgrads, jbn, jm = _jax_step(s, jspec)
    g, bn, tm = _port_step(s, tspec, bn_stats_subsample=subsample)
    _assert_trees_close(tm, jm, rtol=1e-5, atol=1e-4)
    _assert_trees_close(bn, jbn, rtol=1e-5, atol=1e-6)
    _assert_trees_close(g, jgrads, rtol=0, atol=None, scale_by_leaf_max=GRAD_TOL)


def _float64_moments(x):
    """BatchNorm statistics by float64 autograd (no kernel, no f32 sums)."""
    x64 = x.double()
    mean = x64.mean(dim=(0, 2, 3))
    return mean, torch.clamp((x64 * x64).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)


def test_one_step_with_stem_s2d_and_subsample(mini, jax_subsample, monkeypatch):
    """Both keys together. The stem's phase BN then takes its statistics
    from a subsample of a conv0 output whose mean is large against its
    spread, so E[x²] − mean² cancels; the JAX package's f32 sums there
    leave its stem gradients about 1e-2 of the leaf max from float64, the
    port's within 1e-5. So the metrics and BN state are held against JAX as
    above, every gradient leaf outside the stem (layers 0 and 1) against
    JAX's, and every leaf against a float64 run of the port with float64
    BatchNorm statistics, at the same 2e-4 of the leaf max."""
    s = mini
    jax_subsample(2)
    jgrads, jbn, jm = _jax_step(s, js2d.s2d_stem_train(s["jspec"]))
    tspec = ts2d.s2d_stem_train(s["tspec"])
    g, bn, tm = _port_step(s, tspec, bn_stats_subsample=2)
    _assert_trees_close(tm, jm, rtol=1e-5, atol=1e-4)
    _assert_trees_close(bn, jbn, rtol=1e-5, atol=1e-6)
    stem = ("layer0", "layer1")
    outside = lambda t: {k: v for k, v in t["model"].items() if k not in stem}  # noqa: E731
    _assert_trees_close(outside(g), outside(jgrads), rtol=0, atol=None,
                        scale_by_leaf_max=GRAD_TOL)
    monkeypatch.setattr(tlayers, "bn_moments", _float64_moments)
    s64 = dict(s, tp=tree_map(torch.Tensor.double, s["tp"]),
               ts=tree_map(torch.Tensor.double, s["ts"]), images=s["images"].astype(np.float64))
    g64, _, _ = _port_step(s64, tspec, bn_stats_subsample=2)
    _assert_trees_close(g, g64, rtol=0, atol=None, scale_by_leaf_max=GRAD_TOL)


def test_stem_s2d_step_equals_the_unrewritten_step(mini):
    """The rewrite is a reschedule: the same loss, gradients on the original
    kernels and BN state as the plain stem, in the port alone."""
    s = mini
    g, bn, tm = _port_step(s, ts2d.s2d_stem_train(s["tspec"]))
    g0, bn0, tm0 = _port_step(s, s["tspec"])
    np.testing.assert_allclose(tm["total_loss"], tm0["total_loss"], rtol=1e-4)
    _assert_trees_close(g, g0, rtol=0, atol=None, scale_by_leaf_max=GRAD_TOL)
    _assert_trees_close(bn, bn0, rtol=1e-5, atol=1e-6)


# --- multi-scale ---

def _jax_schedules(sizes, mode, interval, seed):
    """``ms_size_for`` / ``ms_size_for_step`` lifted from the JAX trainer's
    source (they are closures inside ``Train.__call__``)."""
    source = open(japp.__file__).read()
    tree = ast.parse(source)
    funcs = {node.name: ast.get_source_segment(source, node) for node in ast.walk(tree)
             if isinstance(node, ast.FunctionDef)
             and node.name in ("ms_size_for", "ms_size_for_step")}
    scope = {"np": np, "ms_sizes": sizes, "ms_mode": mode, "ms_interval": interval,
             "kwargs": {"seed": seed}}
    for text in funcs.values():
        exec(textwrap.dedent(text), scope)
    return scope["ms_size_for"], scope["ms_size_for_step"]


@pytest.mark.parametrize("mode", ["cycle", "random"])
@pytest.mark.parametrize("seed", [0, 3])
def test_multi_scale_schedules_identical_to_jax(mode, seed):
    sizes = [320, 416, 608]
    by_epoch, by_step = _jax_schedules(sizes, mode, 3, seed)
    assert ([tapp.ms_size_for(sizes, mode, seed, e) for e in range(1, 40)]
            == [by_epoch(e) for e in range(1, 40)])
    assert ([tapp.ms_size_for_step(sizes, mode, 3, seed, e, b)
             for e in range(1, 6) for b in range(25)]
            == [by_step(e, b) for e in range(1, 6) for b in range(25)])
    if mode == "random":
        # the step-keyed RandomState seed leaves [0, 2**32) from seed 6 on,
        # in both packages alike
        with pytest.raises(ValueError, match="Seed must be between"):
            _jax_schedules(sizes, mode, 3, 6)[1](1, 0)
        with pytest.raises(ValueError, match="Seed must be between"):
            tapp.ms_size_for_step(sizes, mode, 3, 6, 1, 0)


@pytest.mark.parametrize("src,dst", [(96, 64), (416, 320), (128, 96)])
def test_device_downscale_matches_jax_resize(src, dst):
    im = np.random.RandomState(src).rand(2, src, src, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jax.image.resize(
        x, (2, dst, dst, 3), method="bilinear"))(jnp.asarray(im)))
    got = resize_antialiased(torch.from_numpy(im), dst, dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- whole Train runs ---

def _epoch_losses(lines):
    text = "\n".join(lines)
    return ([float(v) for v in re.findall(r"epoch \d+: train_loss (\S+)", text)],
            [float(v) for v in re.findall(r"epoch \d+: val_loss (\S+)", text)],
            re.findall(r"epoch \d+: multi_scale image_size (\d+)", text))


def test_whole_train_run_matches_jax(tmp_path, mini_file, jax_subsample):
    """Both trainers start from one set of weights (JAX's seeded init, saved
    and loaded by ``transfer_list: [all]``; the two packages' own inits draw
    differently). QAT of the weights only: activation QAT flips lattice
    points on ulps (tests/test_torch_qat.py holds it step by step). Both
    packages decode on one tier (``native_decode_tier``): on different
    tiers the epoch losses were 1–2% apart."""
    jspec = jax_parse(mini_file, 3)
    init = str(tmp_path / "init.tf")
    jax_save_weights(jspec, *jnet.init_model(jax.random.PRNGKey(0), jspec), init)
    keys = dict(model_config_file=mini_file, anchors_file=f"{REPO}/datasets/shapes_toy/anchors/"
                "anchors_tiny.txt", image_size=96, epochs=2, ema=None, qat="weights",
                stem_s2d=True, bn_stats_subsample=2,
                multi_scale={"sizes": [64, 96], "mode": "cycle"},
                device_dataset={"dtype": "uint8"}, shuffle=True,
                transfer_learning_config={"transfer_list": ["all"], "input_weights_path": init})
    with native_decode_tier():
        with _captured_logs() as jlines:
            japp.Train()(**_config(tmp_path / "jax", **keys))
        jax_subsample(1)
        with _captured_logs() as tlines:
            state = tapp.Train()(**_config(tmp_path / "port", device="cpu", **keys))
    jtrain, jval, jsizes = _epoch_losses(jlines)
    ttrain, tval, tsizes = _epoch_losses(tlines)
    assert tsizes == jsizes == ["64", "96"]
    assert len(ttrain) == len(tval) == 2
    np.testing.assert_allclose(ttrain, jtrain, rtol=1e-3)
    np.testing.assert_allclose(tval, jval, rtol=1e-3)
    assert int(state["step"]) == 8
    text = "\n".join(tlines)
    assert "stem_s2d: training stem rescheduled to 2×2-phase layout @64" in text
    assert "device_dataset: staged 32+16 examples" in text and "uint8" in text


def test_train_with_augmentation_and_every_other_key_runs(tmp_path, mini_file):
    tb, trace_dir = tmp_path / "tb", tmp_path / "trace"
    cfg = _config(tmp_path, device="cpu", model_config_file=mini_file,
                  anchors_file=f"{REPO}/datasets/shapes_toy/anchors/anchors_tiny.txt",
                  epochs=2, max_dataset_examples=8,
                  qat={"weights": False, "activations": True, "min_k2cin": 30},
                  augmentation={"flip": True, "scale_jitter": 0.25, "brightness": 0.1,
                                "contrast": 0.1, "mosaic": 0.5, "hue": 0.1,
                                "saturation": 1.5, "exposure": 1.5},
                  stem_s2d=True, multi_scale={"sizes": [64, 96], "interval": 1,
                                              "mode": "random"},
                  device_dataset=True, bn_stats_subsample=2, remat="conv",
                  tensorboard=str(tb), profile_trace_dir=str(trace_dir), mixed_precision=True)
    with _captured_logs() as lines:
        state = tapp.Train()(**cfg)
    train, val, _ = _epoch_losses(lines)
    assert len(train) == 2 and np.all(np.isfinite(train + val))
    text = "\n".join(lines)
    assert "qat: activations" in text and "multi_scale batches per size" in text
    assert len(glob.glob(str(tb / "events.out.tfevents.*"))) == 1
    traces = glob.glob(str(trace_dir / "trace.*.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    assert int(state["step"]) == 2


def _reject_cases():
    return {
        "remat": (dict(remat="all"), "remat must be false, true, or 'conv'"),
        "ms_mode": (dict(multi_scale={"sizes": [64], "mode": "zigzag"}), "cycle|random"),
        "ms_interval": (dict(multi_scale={"sizes": [64], "interval": 0}), "positive"),
        "ms_steps_need_dd": (dict(multi_scale={"sizes": [64], "interval": 2}),
                             "requires device_dataset"),
        "ms_stride": (dict(multi_scale=[60, 96]), "not divisible by the model's max stride"),
        "dd_larger": (dict(multi_scale=[96, 128], device_dataset=True), "every size <="),
        "qat": (dict(qat="int4"), "qat must be true"),
        "saturation": (dict(augmentation={"saturation": 0.5}), "scale BOUND > 1"),
    }


@pytest.mark.parametrize("case", sorted(_reject_cases()))
def test_train_rejects_what_the_jax_trainer_rejects(tmp_path, case):
    keys, message = _reject_cases()[case]
    with pytest.raises(ValueError, match=re.escape(message)) as port_err:
        tapp.Train()(**_config(tmp_path / "port", device="cpu", **keys))
    if case == "saturation":
        return  # the JAX trainer raises it inside its first jitted step
    with pytest.raises(ValueError) as jax_err:
        japp.Train()(**_config(tmp_path / "jax", **keys))
    assert str(port_err.value) == str(jax_err.value)
