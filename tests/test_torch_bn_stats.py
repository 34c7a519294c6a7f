"""K5 in the port (yolov3_tpu_torch/ops/cuda/bn_stats.py, models/layers.py
training-mode batch_norm) against the JAX package, on the CPU.

On CPU tensors the port's wrappers run the plain versions; the JAX kernel
runs in Pallas interpret mode, as in tests/test_pallas_bn_stats.py. Inputs
come from numpy seeds. The JAX package is NHWC, the port logically NCHW: the
same numbers go to both, permuted.

Tolerances: sums rtol 3e-5 / atol 2e-3 (the JAX test's own: two orders of
summation in f32); moments and gradients rtol 1e-4 / atol 1e-6; batch_norm
``y`` 1e-5, new state rtol 1e-5 / atol 1e-6.

Which JAX branch each comparison runs against matters for one case: the
kernel's custom VJP ignores the ``max(·, 0)`` clamp, JAX's default jnp
branch differentiates through it. The constant-channel test pins that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.models import layers as jlayers
from yolov3_tpu.ops.pallas.bn_stats import bn_moments as jax_bn_moments
from yolov3_tpu.ops.pallas.bn_stats import bn_sums as jax_bn_sums
from yolov3_tpu_torch.models import layers as tlayers
from yolov3_tpu_torch.ops.cuda import bn_stats

from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

SHAPES = [(4, 8, 8, 32), (2, 13, 13, 256), (8, 16, 16, 128), (1, 7, 7, 64), (3, 5, 7, 32),
          (2, 4, 4, 1024)]
DTYPES = [("float32", jnp.float32, torch.float32), ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _nchw(x_nhwc, dtype, channels_last):
    """The NHWC numpy array as the port's logical-NCHW tensor, in either
    memory format."""
    t = torch.from_numpy(np.ascontiguousarray(x_nhwc)).to(dtype).permute(0, 3, 1, 2)
    return t if channels_last else t.contiguous()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,jdtype,tdtype", DTYPES)
@pytest.mark.parametrize("channels_last", [True, False])
def test_bn_sums_match_pallas_interpret(shape, name, jdtype, tdtype, channels_last):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    js, js2 = jax_bn_sums(jnp.asarray(x, jdtype), interpret=True)
    ts, ts2 = bn_stats.bn_sums(_nchw(x, tdtype, channels_last))
    assert ts.dtype == ts2.dtype == torch.float32 and tuple(ts.shape) == (shape[-1],)
    atol = 2e-2 if shape[-1] == 1024 else 2e-3
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=3e-5, atol=atol)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), rtol=3e-5, atol=atol)


def _loss_weights(c, seed=7):
    rng = np.random.RandomState(seed)
    return rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)


@pytest.mark.parametrize("name,jdtype,tdtype", DTYPES)
def test_bn_moments_backward_matches_custom_vjp(name, jdtype, tdtype):
    """mean, var and d/dx of Σ(wm·mean + wv·var) against ``jax.grad`` through
    the Pallas kernel's custom VJP."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6, 6, 64).astype(np.float32)
    wm, wv = _loss_weights(64)

    def jax_loss(xj):
        mean, var = jax_bn_moments(xj, True)
        return jnp.sum(mean * wm + var * wv), (mean, var)

    (_, (jmean, jvar)), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(x, jdtype))
    xt = _nchw(x, tdtype, True).detach().requires_grad_(True)
    tmean, tvar = bn_stats.bn_moments(xt)
    (tmean * torch.from_numpy(wm) + tvar * torch.from_numpy(wv)).sum().backward()
    np.testing.assert_allclose(tmean.detach().numpy(), np.asarray(jmean), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tvar.detach().numpy(), np.asarray(jvar), rtol=1e-4, atol=1e-6)
    assert xt.grad.dtype == tdtype
    got = xt.grad.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(jgrad.astype(jnp.float32))
    # bf16: one rounding of dx to 8 bits of mantissa on each side
    rtol, atol = (1e-4, 1e-6) if name == "float32" else (1e-2, 1e-5)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channels_last", [True, False])
def test_bn_moments_forward_matches_pallas_interpret(shape, channels_last):
    """mean and biased var of ``bn_moments`` on the CPU against the JAX
    package's ``bn_moments`` through its Pallas kernel, every shape and both
    memory formats, f32. Tolerance: rtol 1e-4 / atol 1e-5 (var is a difference
    of two sums that were taken in two orders)."""
    x = (np.random.RandomState(11).randn(*shape) * 2 + 0.5).astype(np.float32)
    jmean, jvar = jax_bn_moments(jnp.asarray(x), True)
    tmean, tvar = bn_stats.bn_moments(_nchw(x, torch.float32, channels_last))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=1e-4, atol=1e-5)
    assert float(tvar.min()) >= 0.0


@pytest.mark.parametrize("b,c,hw", [(16, 32, 416 * 416), (16, 1024, 169), (3, 32, 35)])
def test_plan_hands_the_kernel_the_f32_reciprocal(b, c, hw):
    """``_plan`` is cached and pure, and its ``inv_n`` is ``1.0f / f32(n)``:
    what PyTorch's CUDA division of a tensor by a Python scalar multiplies by."""
    for channels_last in (True, False):
        plan = bn_stats._plan(channels_last, b, c, hw)
        assert plan is bn_stats._plan(channels_last, b, c, hw)
        assert plan[4] == float(np.float32(1.0) / np.float32(b * hw))
        assert np.float32(plan[4]) == plan[4]


def test_plain_and_wrapper_agree_on_cpu():
    """On a CPU tensor the wrapper IS the plain version, forward and backward."""
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 16, 5, 5).astype(np.float32))
    for a, b in zip(bn_stats.bn_sums(x), bn_stats.bn_sums_plain(x)):
        assert torch.equal(a, b)
    grads = []
    for fn in (bn_stats.bn_moments, bn_stats.bn_moments_plain):
        xi = x.clone().requires_grad_(True)
        mean, var = fn(xi)
        (mean.sum() + (var * var).sum()).backward()
        grads.append(xi.grad)
    assert torch.equal(grads[0], grads[1])
    assert bn_stats.bn_sums.launches == 0 and bn_stats.bn_moments_dx.launches == 0


def test_constant_channel_follows_the_custom_vjp_not_the_clamp():
    """Where the two JAX branches part. Channel 0 is nearly constant
    (3 + 1e-3·noise): in f32 its ``E[x²] − mean²`` comes out negative with
    this seed, so the variance clamps to 0 while ``x − mean`` is not zero. The
    kernel path (JAX custom VJP, and the port) ignores the clamp and passes
    ``dvar`` through; JAX's default jnp branch differentiates the ``maximum``
    and passes zero there. Channel 1 is exactly constant: ``x − mean`` is 0,
    the dvar term vanishes and both branches give ``dmean / n``."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 6, 6, 8).astype(np.float32)
    x[..., 0] = (3.0 + 1e-3 * rng.randn(4, 6, 6)).astype(np.float32)
    x[..., 1] = 0.1
    n = 4 * 6 * 6
    wm, wv = _loss_weights(8)
    wv[0] = 50.0

    def kernel_loss(xj):
        mean, var = jax_bn_moments(xj, True)
        return jnp.sum(mean * wm + var * wv)

    def jnp_moments(xj):
        mean = jnp.mean(xj, axis=(0, 1, 2))
        return mean, jnp.mean(xj * xj, axis=(0, 1, 2)) - mean * mean

    def jnp_loss(xj):
        mean, raw = jnp_moments(xj)
        return jnp.sum(mean * wm + jnp.maximum(raw, 0.0) * wv)

    assert float(jnp_moments(jnp.asarray(x))[1][0]) < 0.0  # the clamp is active in JAX
    g_kernel = np.asarray(jax.grad(kernel_loss)(jnp.asarray(x)))  # the custom VJP
    g_jnp = np.asarray(jax.grad(jnp_loss)(jnp.asarray(x)))        # through the maximum
    xt = _nchw(x, torch.float32, True).detach().requires_grad_(True)
    mean, var = bn_stats.bn_moments(xt)
    (mean * torch.from_numpy(wm) + var * torch.from_numpy(wv)).sum().backward()
    got = xt.grad.permute(0, 2, 3, 1).numpy()
    # the port against the custom VJP: every channel, the clamped one too
    np.testing.assert_allclose(got, g_kernel, rtol=1e-4, atol=1e-6)
    # against the jnp branch: equal except in the clamped channel, where the
    # jnp branch has dmean / n alone and the kernel path adds the dvar term
    np.testing.assert_allclose(got[..., 1:], g_jnp[..., 1:], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g_jnp[..., 0], wm[0] / n, rtol=1e-5)
    assert np.abs(got[..., 0] - wm[0] / n).max() > 1e-4
    # the exactly constant channel: dmean / n on every path
    np.testing.assert_allclose(got[..., 1], wm[1] / n, rtol=1e-5)


def _bn_case(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    params = {"gamma": rng.rand(c).astype(np.float32) + 0.5,
              "beta": rng.randn(c).astype(np.float32)}
    state = {"mean": rng.randn(c).astype(np.float32) * 0.1,
             "var": rng.rand(c).astype(np.float32) + 0.5}
    return x, params, state


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("name,jdtype,tdtype", DTYPES)
def test_training_batch_norm_matches_jax(monkeypatch, pallas, name, jdtype, tdtype):
    """``batch_norm(train=True)``: y and the new running statistics against
    the JAX function, with YOLOV3_PALLAS_BN_STATS set (the kernel branch,
    interpret mode) and unset (the jnp branch)."""
    if pallas:
        monkeypatch.setenv("YOLOV3_PALLAS_BN_STATS", "1")
    else:
        monkeypatch.delenv("YOLOV3_PALLAS_BN_STATS", raising=False)
    x, params, state = _bn_case(4, (2, 8, 8, 32), name)
    jy, jstate = jlayers.batch_norm(jnp.asarray(x, jdtype), jax.tree.map(jnp.asarray, params),
                                    jax.tree.map(jnp.asarray, state), train=True)
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731
    ty, tstate = tlayers.batch_norm(_nchw(x, tdtype, True), t(params), t(state), train=True)
    assert ty.dtype == tdtype and tstate["mean"].dtype == torch.float32
    # bf16: y is computed in bf16 on both sides (three roundings)
    tol = 1e-5 if name == "float32" else 6e-2
    np.testing.assert_allclose(ty.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy.astype(jnp.float32)), rtol=tol, atol=tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   rtol=1e-5, atol=1e-6)


def test_training_batch_norm_gradients_match_jax():
    """d/dx, d/dgamma, d/dbeta of Σ(w·y) through training-mode BN (jnp branch:
    no channel clamps here, so both JAX branches agree)."""
    x, params, state = _bn_case(6, (2, 6, 6, 16), "float32")
    w = np.random.RandomState(8).randn(2, 6, 6, 16).astype(np.float32)

    def jax_loss(xj, p):
        y, _ = jlayers.batch_norm(xj, p, jax.tree.map(jnp.asarray, state), train=True)
        return jnp.sum(y * w)

    jgx, jgp = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    xt = _nchw(x, torch.float32, False).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    y, new_state = tlayers.batch_norm(xt, tp, {k: torch.from_numpy(v) for k, v in state.items()},
                                      train=True)
    (y * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    assert not new_state["mean"].requires_grad  # the running statistics carry no graph
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx),
                               rtol=1e-3, atol=1e-5)
    for k in ("gamma", "beta"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]), rtol=1e-4, atol=1e-4)


def test_inference_batch_norm_returns_the_state_it_was_given():
    x, params, state = _bn_case(9, (1, 4, 4, 8), "float32")
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731
    ts = t(state)
    y, new_state = tlayers.batch_norm(_nchw(x, torch.float32, True), t(params), ts)
    jy, _ = jlayers.batch_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, state), train=False)
    assert new_state is ts
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_phases_and_wrong_inputs_raise():
    """``phases=4`` takes the statistics of the phase groups (JAX's
    ``batch_norm(phases=4)``, 1e-5); an activation in neither dense layout
    has no phase view and raises."""
    x, params, state = _bn_case(11, (2, 4, 4, 8), "float32")
    p = {"gamma": torch.from_numpy(params["gamma"][:2]), "beta": torch.from_numpy(params["beta"][:2])}
    s = {"mean": torch.from_numpy(state["mean"][:2]), "var": torch.from_numpy(state["var"][:2])}
    y, new_state = tlayers.batch_norm(_nchw(x, torch.float32, True), p, s, train=True, phases=4)
    jy, jstate = jlayers.batch_norm(jnp.asarray(x), {k: jnp.asarray(v[:2]) for k, v in params.items()},
                                    {k: jnp.asarray(v[:2]) for k, v in state.items()}, train=True,
                                    phases=4)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_state[k].numpy(), np.asarray(jstate[k]), rtol=1e-5,
                                   atol=1e-6)
    strided = torch.zeros((2, 16, 4, 4))[:, ::2]
    with pytest.raises(ValueError, match="phase view"):
        tlayers.batch_norm(strided, p, s, train=True, phases=4)
