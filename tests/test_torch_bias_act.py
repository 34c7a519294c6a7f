"""K8, the folded fp conv's tail (yolov3_tpu_torch/ops/cuda/bias_act.py), on
the CPU: its plain version against the expressions it replaced, the routing
of ``models/layers.py::bias_act``, the ``yolov3_torch::bias_act`` op (schema,
fake kernel, ``torch.export``), the checks its CUDA kernel makes before a
launch, and the benchmark's reader of its roofline share
(``portbench/metrics/bias_act_roofline.infer.py``) on synthetic records.

Tolerance: none. The plain version, the op on CPU tensors and the models'
forwards through them are bit-equal to the expressions of the tail before
K8 (``x + bias.to(x.dtype)``, then ``layers.leaky_relu`` or ``layers.mish``);
the reader's values are worked out by hand."""

import os

import numpy as np
import pytest
import torch

from portbench.records import Records, reader
from portbench.trace import Trace
from yolov3_tpu_torch.apps.inference_app import make_predictor
from yolov3_tpu_torch.export import aot
from yolov3_tpu_torch.models import layers as L
from yolov3_tpu_torch.models import network as tnet
from yolov3_tpu_torch.models.spec import parse_model_config
from yolov3_tpu_torch.ops.cuda import bias_act as K

from .conftest import REPO
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

ACTIVATIONS = K.ACTIVATIONS


def _parent_tail(x, bias, activation):
    """The bias branch of ``models/network.py::_conv_tail`` before K8."""
    y = x + bias.to(x.dtype).view(1, -1, 1, 1)
    return L.leaky_relu(y) if activation == "leaky" else L.mish(y) if activation == "mish" else y


def _case(seed, shape, dtype, channels_last, bias_dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(*shape) * 3).astype(np.float32)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last) if channels_last else x.contiguous()
    bias = torch.from_numpy(rng.uniform(-2, 2, shape[1]).astype(np.float32)).to(bias_dtype)
    return x, bias


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _op_called(fn):
    """Whether ``fn()`` dispatched ``yolov3_torch::bias_act`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return any(e.name == "yolov3_torch::bias_act" for e in prof.events())


@pytest.mark.parametrize("c", [3, 32, 255, 1024])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
def test_plain_and_the_op_are_the_parents_expression(c, activation, dtype, channels_last):
    """``bias_act_plain`` and the op on CPU tensors against the tail's
    expressions before K8, bit for bit, with an f32 and an x-dtype bias; the
    result keeps x's memory format; no kernel launch."""
    for bias_dtype in (torch.float32, dtype):
        x, bias = _case(c, (2, c, 5, 7), dtype, channels_last, bias_dtype)
        want = _parent_tail(x, bias, activation)
        launches = K.bias_act.launches
        for got in (K.bias_act_plain(x, bias, activation), K.bias_act(x, bias, activation)):
            assert got.dtype == dtype and got.stride() == x.stride()
            assert torch.equal(_bits(got), _bits(want))
        assert K.bias_act.launches == launches


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_route_keeps_the_plain_expression_where_autograd_records(activation):
    """With grad recording and x or the bias requiring grad, the tail is the
    plain expression (differentiable, no op), counted ``"autograd"``; under
    ``no_grad``, ``inference_mode`` or with nothing requiring grad it is the
    op, counted ``"fused"``. Both give the same bits."""
    x, bias = _case(1, (2, 16, 6, 6), torch.float32, True)
    want = _parent_tail(x, bias, activation)
    K.bias_act.tails.clear()
    for leaf in ("x", "bias"):
        xi = x.clone().requires_grad_(leaf == "x")
        bi = bias.clone().requires_grad_(leaf == "bias")
        with torch.enable_grad():
            assert not _op_called(lambda: L.bias_act(xi, bi, activation))
            y = L.bias_act(xi, bi, activation)
        assert y.grad_fn is not None and torch.equal(y.detach(), want)
        y.sum().backward()
        assert (xi.grad if leaf == "x" else bi.grad) is not None
    assert dict(K.bias_act.tails) == {"autograd": 4}
    xr = x.clone().requires_grad_(True)
    for context, xi in ((torch.no_grad, xr), (torch.inference_mode, x), (torch.enable_grad, x)):
        with context():
            assert _op_called(lambda: L.bias_act(xi, bias, activation))
            y = L.bias_act(xi, bias, activation)
        assert y.grad_fn is None and torch.equal(y, want)
    assert dict(K.bias_act.tails) == {"autograd": 4, "fused": 6}


def _seeded(model, size, dtype):
    """A model config's spec, seeded folded params (BN betas U(0.8, 1.2), as
    YOLOv4's tests take them) in ``dtype``, and two seeded images."""
    spec = parse_model_config(os.path.join(REPO, f"config/models/{model}/model.yaml"), 80)
    g = torch.Generator().manual_seed(3)
    params, state = tnet.init_model(spec, g)
    for sm_params in params.values():
        for entry in sm_params.values():
            if "bn" in entry:
                c = entry["bn"]["gamma"].shape[0]
                entry["bn"] = {"gamma": 0.8 + 0.4 * torch.rand(c, generator=g),
                               "beta": 0.8 + 0.4 * torch.rand(c, generator=g)}
            else:
                entry["bias"] = 0.4 * torch.rand(entry["bias"].shape, generator=g) - 0.2
    folded = tnet.to_device(tnet.fold_batch_norm(params, state), "cpu", dtype)
    images = torch.rand((2, size, size, 3), generator=g).to(dtype)
    return spec, folded, images


@pytest.mark.parametrize("model,tails", [("yolov3", 75), ("yolov4", 110)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_tail_gives_the_parents_bits(model, tails, dtype, monkeypatch):
    """The folded forward of YOLOv3 and YOLOv4 at 64² (B=2, channels-last
    images) with every fp tail through the op, against the same forward with
    the tail as it was before K8: heads bit-equal; each conv's tail counted
    once, ``"fused"``."""
    spec, folded, images = _seeded(model, 64, dtype)
    K.bias_act.tails.clear()
    with torch.inference_mode():
        heads = tnet.apply_model(spec, folded, {}, images)
    assert dict(K.bias_act.tails) == {"fused": tails}
    assert sum(spec.activation_counts.values()) == tails
    monkeypatch.setattr(L, "bias_act", _parent_tail)
    with torch.inference_mode():
        want = tnet.apply_model(spec, folded, {}, images)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(heads, want))


def test_export_keeps_one_node_a_conv_and_matches_eager():
    """``torch.export`` of a YOLOv3-tiny fp32 predictor at 64² (seeded
    weights) holds one ``yolov3_torch::bias_act`` node for each of its 13
    convs, and the program answers B = 1 and 3 bit-equal to the eager
    predictor."""
    spec = parse_model_config(os.path.join(REPO, "config/models/yolov3_tiny/model.yaml"), 3)
    params, state = tnet.init_model(spec, torch.Generator().manual_seed(5))
    anchors = np.linspace(0.05, 0.6, 12, dtype=np.float32).reshape(2, 3, 2)
    predictor = make_predictor(spec, params, state, anchors, 3, 20, 0.5, 0.01, image_size=64,
                               device="cpu")
    program = aot.export_detector(predictor.module, 64, ("cpu",))["cpu"]
    nodes = [n for n in program.graph_module.graph.nodes
             if str(n.target) == "yolov3_torch.bias_act.default"]
    assert len(nodes) == sum(spec.activation_counts.values()) == 13
    module = program.module()
    for b in (1, 3):
        images = torch.from_numpy(np.random.RandomState(b).rand(b, 64, 64, 3).astype(np.float32))
        with torch.inference_mode():
            got, want = module(images), predictor(images)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
def test_fake_kernel_keeps_the_memory_format(dtype, channels_last):
    """``torch.library.opcheck`` on the op (schema, the fake kernel against
    the CPU kernel, a dynamic batch) for each activation; under fake tensors
    the output has x's shape, dtype and strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, bias = _case(2, (3, 24, 7, 5), dtype, channels_last)
    for activation in ACTIVATIONS:
        torch.library.opcheck(torch.ops.yolov3_torch.bias_act.default, (x, bias, activation))
    with FakeTensorMode() as mode:
        fx, fb = mode.from_tensor(x), mode.from_tensor(bias)
        y = torch.ops.yolov3_torch.bias_act.default(fx, fb, "mish")
    assert tuple(y.shape) == tuple(x.shape) and y.dtype == dtype and y.stride() == x.stride()


def test_the_kernels_checks_before_a_launch():
    """What the CUDA kernel takes, read on CPU tensors before any launch:
    the layout it reads (channels-last or NCHW), and a refusal naming what
    it lacks; the grid plan."""
    x, bias = _case(4, (2, 8, 6, 6), torch.float32, False)
    assert K._check(x, bias, "leaky") is False
    assert K._check(x.contiguous(memory_format=torch.channels_last), bias, "mish") is True
    for xi, b, act, match in ((x[:, :, ::2], bias, "leaky", "layout"),
                              (x.half(), bias, "leaky", "activation"),
                              (x.double(), bias, "leaky", "activation"),
                              (x[0], bias, "leaky", "activation"),
                              (x, bias[:4], "leaky", "bias"),
                              (x, bias.double(), "leaky", "bias"),
                              (x, bias, "relu", "activation must be one of")):
        with pytest.raises(ValueError, match=match):
            K._check(xi, b, act)
    with pytest.raises(ValueError, match="activation must be one of"):
        K.bias_act_plain(x, bias, "relu")
    assert K.plan(100, 8) == 1
    assert K.plan(128 * 32 * 416 * 416, 8) == 128 * 32 * 416 * 416 // 8 // 256
    assert K.plan(256 * 8 + 3, 8) == 2 and K.plan(256 * 8, 8) == 1 and K.plan(257, 1) == 2


# the reader's synthetic records: two convs of one sub-model's table
TABLE = {("head", 3): {"kind": "convolutional", "out": (255, 13, 13), "cout": 255, "macs": 0},
         ("head", 5): {"kind": "convolutional", "out": (64, 26, 26), "cout": 64, "macs": 0},
         ("head", 6): {"kind": "shortcut", "out": (64, 26, 26), "macs": 0}}


def _records(attributed, tier="bf16", batch=4, units=2):
    trace = Trace([], (0.0, 100.0), list(attributed), [], units)
    return Records({"tier": tier}, {}, TABLE, batch, {}, {}, trace)


@pytest.mark.parametrize("tier,esize", [("bf16", 2), ("fp32", 4), ("int8_chain", 4)])
def test_bias_act_roofline_reads_the_ranges_that_hold_k8(tier, esize):
    """The least time of the tails that ran K8 (bytes from the table: the
    conv's output read and written at the batch, the bias read, in the
    tier's element size) over the device time of their ``bias_act``
    kernels; other kernels and other ranges are not counted; None where no
    ``bias_act`` kernel ran, and without a trace."""
    conv3, conv5 = "L|head|layer3|convolutional", "L|head|layer5|convolutional"
    attributed = [
        ("void bias_act_linear_kernel<__nv_bfloat16, 8, true>(Args)", 3.0, conv3, "predict"),
        ("void bias_act_linear_kernel<__nv_bfloat16, 8, true>(Args)", 3.5, conv3, "predict"),
        ("sm90_xmma_fprop_implicit_gemm", 50.0, conv5, "predict"),
        ("void bias_act_leaky_kernel<__nv_bfloat16, 8, true>(Args)", 9.0, conv5, "predict"),
        ("void bias_act_leaky_kernel<__nv_bfloat16, 8, true>(Args)", 9.5, conv5, "predict"),
        ("elementwise_kernel add", 7.0, "L|head|layer6|shortcut", "predict"),
        ("nms_sweep_kernel", 4.0, None, "predict")]
    nbytes = (4 * 255 * 13 * 13 * 2 * esize + 255 * esize) + (4 * 64 * 26 * 26 * 2 * esize
                                                              + 64 * esize)
    want = 100 * nbytes / 3.35e12 * 2 / (25.0 / 1e6)
    read = reader("bias_act_roofline.infer")
    assert read(_records(attributed, tier)) == pytest.approx(want)
    assert read(_records([a for a in attributed if "bias_act" not in a[0]], tier)) is None
    assert read(Records({"tier": tier}, {}, TABLE, 4, {}, {}, None)) is None
