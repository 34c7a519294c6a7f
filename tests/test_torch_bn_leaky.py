"""K7, the training BatchNorm tail (yolov3_tpu_torch/ops/cuda/bn_leaky.py),
on the CPU: its plain backward against autograd of the expression it
replaces, the routing of ``models/layers.py::batch_norm``, and the train step
with the tail forced through the autograd Function (the plain versions run
inside it on CPU tensors).

Tolerances:
  * the plain backward against autograd of the plain expression: in f32 dx
    bit-equal (the same products); the (C,) gradients 1e-5 of their sums'
    Σ|term| (another order of summation). In bf16 the expression's autograd
    rounds every intermediate gradient to bf16 where the backward keeps f32:
    dx within 2^-7 of each element (one bf16 ulp), the (C,) gradients within
    2^-6 of Σ|term| (three bf16 roundings of the terms and the sums);
  * the Function inside ``batch_norm`` (phase groups included) against the
    plain path: y bit-equal; gradients 1e-5 (f32) and 2^-6 (bf16) of each
    tensor's largest entry;
  * the train step with every tail forced through the Function: gradients
    within 2e-5 of each leaf's largest entry of the plain step's (f32,
    ``remat`` off and ``"conv"``, with and without the space-to-depth stem);
    remat "conv" against no remat through the Function: bit-equal."""

import os

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.models import layers as L
from yolov3_tpu_torch.models import network as tnet
from yolov3_tpu_torch.models.spec import parse_model_config
from yolov3_tpu_torch.ops import s2d as ts2d
from yolov3_tpu_torch.ops.cuda import bn_leaky as K
from yolov3_tpu_torch.parallel import train_step as tts
from yolov3_tpu_torch.tree import tree_leaves

from .conftest import REPO
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)
from .test_torch_train_extras import MINI

EPS, SLOPE = L.BN_EPS, L.LEAKY_SLOPE
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def _case(seed, shape, dtype, channels_last):
    """x, dy, mean, var, gamma, beta. Channel 0 is constant with zero
    variance and beta 0, so its pre-activation is exactly 0 everywhere;
    channel 1's mean is one of its elements (beta 0), so v is exactly 0
    there; the other channels take the batch's statistics."""
    rng = np.random.RandomState(seed)
    b, c, h, w = shape
    x = (rng.randn(*shape) * 2 + rng.randn(1, c, 1, 1)).astype(np.float32)
    x[:, 0] = 1.5
    x = torch.from_numpy(x).to(dtype)
    mean, var = x.float().mean(dim=(0, 2, 3)), x.float().var(dim=(0, 2, 3), unbiased=False)
    mean[1] = x[0, 1, 0, 0].float()
    gamma = torch.from_numpy(rng.uniform(0.8, 1.2, c).astype(np.float32)).to(dtype)
    beta = torch.from_numpy(rng.uniform(-0.2, 0.2, c).astype(np.float32)).to(dtype)
    beta[:2] = 0
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    if channels_last:
        x, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
    assert float(var[0]) == 0.0
    return x, dy, mean, var, gamma, beta


def _expression(x, mean, var, gamma, beta):
    """The tail as ``batch_norm`` computed it before K7: the normalization
    with the given statistics, then ``leaky_relu``."""
    y, _ = L.batch_norm(x, {"gamma": gamma, "beta": beta},
                        {"mean": torch.zeros_like(mean), "var": torch.ones_like(var)},
                        train=True, moments=(mean, var))
    return L.leaky_relu(y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_bn_leaky_dx_plain_matches_autograd_of_the_expression(dtype, channels_last):
    x, dy, mean, var, gamma, beta = _case(3, (3, 8, 5, 7), dtype, channels_last)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, mean, var, gamma, beta)]
    y = _expression(*leaves)
    v = K.bn_apply_plain(x, mean, gamma * torch.rsqrt(var + EPS), beta)
    assert int((v == 0).sum()) >= x.shape[0] * x.shape[2] * x.shape[3] + 1  # v exactly 0
    y.backward(dy)
    dx, dmean, dvar, dgamma, dbeta = K.bn_leaky_dx_plain(x, dy, mean, var, gamma, beta, EPS,
                                                          SLOPE)
    assert dx.dtype == dtype and dx.stride() == x.stride()
    assert (dmean.dtype, dvar.dtype, dgamma.dtype, dbeta.dtype) == (
        torch.float32, torch.float32, dtype, dtype)
    if dtype == torch.float32:
        assert torch.equal(dx, leaves[0].grad)
    else:
        want = leaves[0].grad.float()
        assert bool(((dx.float() - want).abs() <= 2.0 ** -7 * want.abs()).all())
    # the (C,) gradients against their sums' Σ|term|
    r = torch.rsqrt(var + EPS)
    s = (gamma.float() * r).to(dtype).float()
    d = (x - mean.to(dtype).view(1, -1, 1, 1)).float()
    dy32 = dy.float()
    g = torch.where(v >= 0, dy32, dy32 * SLOPE)
    a0, a1 = g.abs().sum(dim=(0, 2, 3)), (g * d).abs().sum(dim=(0, 2, 3))
    for got, want, scale in ((dbeta, leaves[4].grad, a0), (dgamma, leaves[3].grad, a1 * r),
                             (dmean, leaves[1].grad, a0 * s),
                             (dvar, leaves[2].grad, a1 * 0.5 * gamma.float() * r ** 3)):
        assert bool(((got.float() - want.float()).abs() <= TOL[dtype] * scale + 1e-30).all())


@pytest.mark.parametrize("phases", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_batch_norm_through_the_function_matches_the_plain_path(monkeypatch, phases, dtype,
                                                                channels_last):
    """``batch_norm(train=True, leaky=True)`` with K7's route taken on the
    CPU (the route forced; the Function runs its plain versions) against
    the plain path: the statistics flow from K5's plain version into the
    Function, and with phase groups the Function takes the tiled vectors.
    Unforced, the real predicate passes the tiled vectors of the phase
    groups and only the device keeps the tail off K7 (``not cuda``)."""
    x, dy, _, _, gamma, beta = _case(5, (2, 4 * phases, 6, 5), dtype, channels_last)
    params = {"gamma": gamma[:4].float(), "beta": beta[:4].float()}
    state = {"mean": torch.zeros(4), "var": torch.ones(4)}
    runs = []
    for forced in (False, True):
        if forced:
            monkeypatch.setattr(K, "route", lambda *args: "fused")
        before = K.bn_leaky.tails.copy()
        xi = x.detach().clone().requires_grad_(True)
        p = {k: t.to(dtype).detach().requires_grad_(True) for k, t in params.items()}
        y, new_state = L.batch_norm(xi, p, state, train=True, phases=phases, leaky=True)
        y.backward(dy)
        runs.append((y.detach(), new_state, xi.grad, p["gamma"].grad, p["beta"].grad))
        assert K.bn_leaky.tails - before == {("fused" if forced else "not cuda"): 1}
    (y0, st0, *g0), (y1, st1, *g1) = runs
    assert torch.equal(y0, y1) and y1.stride() == x.stride()
    assert all(torch.equal(st0[k], st1[k]) for k in st0)
    for got, want in zip(g1, g0):
        assert got.dtype == want.dtype
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= TOL[dtype] * scale


def test_routing_keeps_the_plain_path_where_k7_does_not_apply(monkeypatch):
    """On the CPU, for a non-leaky tail, an activation in neither dense
    layout and one of another dtype, training BatchNorm evaluates the plain
    expression (bit-equal to it) and counts the reason; inference never
    reaches K7 even where the predicate would take the tail."""
    x, _, mean, var, gamma, beta = _case(7, (2, 6, 8, 8), torch.float32, True)
    params, state = {"gamma": gamma, "beta": beta}, {"mean": mean, "var": var}
    cases = [(x, True, "not cuda"), (x, False, "no leaky"), (x[:, :, ::2], True, "layout"),
             (x.double(), True, "activation torch.float64 4-d")]
    for xi, leaky, reason in cases:
        before = K.bn_leaky.tails.copy()
        y, _ = L.batch_norm(xi, params, state, train=True, leaky=leaky)
        assert K.bn_leaky.tails - before == {reason: 1}
        plain, _ = L.batch_norm(xi, params, state, train=True)
        assert torch.equal(y, L.leaky_relu(plain) if leaky else plain)

    def refuse(*args):
        raise AssertionError("inference reached K7")

    tails, before = K.bn_leaky.tails, K.bn_leaky.tails.copy()
    monkeypatch.setattr(K, "route", lambda *args: "fused")
    monkeypatch.setattr(K, "bn_leaky_routed", refuse)
    y, new_state = L.batch_norm(x, params, state, train=False, leaky=True)
    assert new_state is state and tails == before
    assert torch.equal(y, L.leaky_relu(K.bn_apply_plain(
        x, mean, gamma * torch.rsqrt(var + EPS), beta)))


@pytest.mark.parametrize("phases", [1, 4])
def test_the_predicate_reads_the_vectors_tiled_to_the_phase_groups(phases):
    """The space-to-depth stem's BatchNorm normalizes ``phases`` channel
    groups with one (C,) set of vectors: ``fallback_reason`` passes them
    tiled to x's channels and names the untiled ones (``statistics``), and
    ``route`` keeps a CPU tail off K7 with ``not cuda`` only when nothing else
    is missing."""
    x, _, mean, var, gamma, beta = _case(9, (2, 4 * phases, 6, 6), torch.float32, True)
    vectors = [t[:4] for t in (mean, var, gamma, beta)]
    tiled = [t.repeat(phases) for t in vectors]
    assert K.fallback_reason(x, *tiled) is None
    assert K.route(x, *tiled) == "not cuda"
    if phases > 1:
        assert K.fallback_reason(x, *vectors) == "statistics"
        assert K.route(x, *vectors) == "statistics"
    assert K.route(x[:, :, ::2], *tiled) == "layout"
    assert K.route(x.double(), *tiled) == "activation torch.float64 4-d"


def test_the_model_counts_one_tail_a_bn_conv_in_training_only():
    """The tiny model's training forward counts each of its 11 BN convs'
    tails once (on the CPU: ``not cuda``); its head convs (bias, no BN) and
    an inference forward count none."""
    spec = parse_model_config(os.path.join(REPO, "config/models/yolov3_tiny/model.yaml"), 3)
    params, state = tnet.init_model(spec, torch.Generator().manual_seed(0))
    images = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    before = K.bn_leaky.tails.copy()
    tnet.apply_model(spec, params, state, images)
    assert K.bn_leaky.tails == before
    tnet.apply_model(spec, params, state, images, train=True)
    assert K.bn_leaky.tails - before == {"not cuda": 11}


@pytest.fixture(scope="module")
def mini_step(tmp_path_factory):
    path = tmp_path_factory.mktemp("k7") / "mini.yaml"
    path.write_text(MINI)
    spec = parse_model_config(str(path), 3)
    params, state = tnet.init_model(spec, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    for sm in params.values():  # non-trivial BN parameters
        for entry in sm.values():
            if "bn" in entry:
                c = entry["bn"]["gamma"].shape[0]
                entry["bn"] = {"gamma": torch.from_numpy(rng.uniform(0.5, 1.5, c)).float(),
                               "beta": torch.from_numpy(rng.randn(c) * 0.1).float()}
    images = torch.from_numpy(rng.rand(4, 96, 96, 3).astype(np.float32))
    labels = np.zeros((4, 10, 6), np.float32)
    for b in range(4):
        for m in range(3):
            x0, y0 = rng.rand(2) * 0.6
            w, h = rng.rand(2) * 0.3 + 0.05
            labels[b, m] = [x0, y0, x0 + w, y0 + h, 1, rng.randint(3)]
    anchors = np.array([[0.1, 0.1], [0.2, 0.2], [0.3, 0.3], [0.4, 0.4], [0.5, 0.5],
                        [0.6, 0.6]], np.float32).reshape(2, 3, 2)
    return dict(spec=spec, params=params, state=state, images=images,
                labels=torch.from_numpy(labels), anchors=anchors,
                grids=tnet.head_grid_sizes(spec, 96))


def _grads(s, spec, remat):
    grads, _, metrics = tts.loss_and_grads(spec, s["params"], s["state"], s["images"],
                                           s["labels"], s["anchors"], s["grids"], 4,
                                           remat=remat)
    return tree_leaves(grads), float(metrics["total_loss"])


@pytest.mark.parametrize("stem_s2d", [False, True])
def test_train_step_through_the_function_matches_the_plain_step(monkeypatch, mini_step,
                                                                stem_s2d):
    """Every BN tail of the step forced through K7's Function: the loss as
    the plain step's, each gradient leaf within 2e-5 of its largest entry;
    with ``remat: conv`` the tails run again in the backward, through the
    Function too, and give the same bits."""
    s = mini_step
    spec = ts2d.s2d_stem_train(s["spec"]) if stem_s2d else s["spec"]
    n_bn = sum("bn" in e for sm in s["params"].values() for e in sm.values())
    want, want_loss = _grads(s, spec, False)
    monkeypatch.setattr(K, "route", lambda *args: "fused")
    before = K.bn_leaky.tails.copy()
    got, loss = _grads(s, spec, False)
    assert K.bn_leaky.tails - before == {"fused": n_bn}
    again, _ = _grads(s, spec, "conv")
    assert K.bn_leaky.tails - before == {"fused": 3 * n_bn}  # the remat ran every tail twice
    assert loss == want_loss
    for g, w, r in zip(got, want, again):
        assert float((g - w).abs().max()) <= 2e-5 * max(float(w.abs().max()), 1e-30)
        assert torch.equal(g, r)
