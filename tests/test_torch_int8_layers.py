"""The port's int8 layer ops and the plain versions of its int8 kernels
(yolov3_tpu_torch/models/layers.py, ops/cuda/{conv1x1,conv_int8,resblock}.py)
against the JAX package, on the CPU.

On CPU tensors the port's kernel wrappers run their plain versions, so
``conv2d_int8`` here exercises ``conv1x1_int8_requant_plain`` (1×1 stride 1)
and ``conv_int8_plain`` (everything else). The Pallas kernels run in
interpret mode, as the JAX package's own tests run them.

Tolerance: none, with one stated exception (the fp output of the interpreted
Pallas 1×1 kernel). Integers equal, fp outputs bit-equal: every sum here stays
below 2^24 (9·Cin·127² with Cin ≤ 64), where JAX's f32 accumulation is as
exact as the port's integer sums, and both epilogues round in one order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.models import layers as JL
from yolov3_tpu.ops.pallas import conv1x1 as JC
from yolov3_tpu.ops.pallas import resblock as JR
from yolov3_tpu_torch.models import layers as TL
from yolov3_tpu_torch.models.convert import qparams_from_jax
from yolov3_tpu_torch.ops.cuda import conv1x1 as TC
from yolov3_tpu_torch.ops.cuda import resblock as TR

from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qact(rng, shape, scale):
    q = rng.randint(-127, 128, shape).astype(np.int8)
    return (JL.QAct(jnp.asarray(q), jnp.float32(scale)),
            TL.QAct(_t(q), torch.tensor(scale, dtype=torch.float32)))


def test_requantize_and_dequantize_match_jax():
    rng = np.random.RandomState(0)
    # values on and around the rounding ties and the clip edges
    y = np.concatenate([rng.randn(4000) * 3, (np.arange(-300, 300) + 0.5) * 0.0413,
                        [1e9, -1e9, 0.0]]).astype(np.float32).reshape(1, -1, 1, 1)
    scale = np.float32(0.0413)
    jq = JL.requantize(jnp.asarray(y), jnp.float32(scale))
    tq = TL.requantize(_t(y), torch.tensor(scale))
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(TL.dequantize(tq).numpy(), np.asarray(JL.dequantize(jq)))


def test_add_requant_matches_jax():
    rng = np.random.RandomState(1)
    ja, ta = _qact(rng, (2, 5, 6, 16), 0.0413)
    jb, tb = _qact(rng, (2, 5, 6, 16), 0.0727)
    jo = JL.add_requant(ja, jb, jnp.float32(0.0611))
    to = TL.add_requant(ta, tb, torch.tensor(0.0611))
    np.testing.assert_array_equal(to.q.numpy(), np.asarray(jo.q))
    assert float(to.scale) == float(jo.scale)


CONVS = [  # kernel, stride, explicit_pad, cin, cout
    pytest.param(1, 1, None, 16, 24, id="1x1"),
    pytest.param(3, 1, None, 16, 24, id="3x3s1"),
    pytest.param(3, 2, None, 16, 24, id="3x3s2"),
    pytest.param(4, 2, ((1, 2), (1, 2)), 3, 32, id="4x4s2-stem"),
    pytest.param(2, 1, ((1, 0), (1, 0)), 32, 16, id="2x2s1-stem"),
    pytest.param(3, 1, None, 3, 8, id="3x3s1-cin3"),
]


def _qparams(rng, k, cin, cout, chain):
    qp = {"kernel_q": rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8),
          "w_scale": (rng.rand(cout) * 1e-3 + 1e-4).astype(np.float32),
          "in_scale": np.float32(0.0371),
          "bias": rng.randn(cout).astype(np.float32)}
    if chain:
        qp["out_scale"] = np.float32(0.0529)
    return qp


@pytest.mark.parametrize("k,stride,explicit_pad,cin,cout", CONVS)
@pytest.mark.parametrize("leaky", [True, False])
def test_conv2d_int8_fp_in_fp_out_matches_jax(k, stride, explicit_pad, cin, cout, leaky):
    rng = np.random.RandomState(k * 10 + stride)
    qp = _qparams(rng, k, cin, cout, chain=False)
    x = (rng.randn(2, 10, 12, cin) * 2).astype(np.float32)
    want = JL.conv2d_int8(jnp.asarray(x), {n: jnp.asarray(v) for n, v in qp.items()},
                          stride, 1, leaky=leaky, explicit_pad=explicit_pad)
    got = TL.conv2d_int8(_t(x), qparams_from_jax(qp), stride, 1, leaky=leaky,
                         explicit_pad=explicit_pad)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_input_quantization_is_a_true_division():
    """An fp input is quantized as round(x / in_scale), a true f32 division,
    not x · (1/in_scale): the two differ just off the rounding ties. The input
    is every half-step of the lattice and its f32 neighbours, through a 1×1
    identity conv (weight 1, scale 1, no bias), so a q that is off by one
    shows as a step of in_scale in the fp output."""
    in_scale = np.float32(0.0371)
    ties = ((np.arange(-127, 127) + 0.5) * in_scale).astype(np.float32)
    x = np.concatenate([ties, np.nextafter(ties, np.float32(np.inf)),
                        np.nextafter(ties, np.float32(-np.inf))]).reshape(1, 1, -1, 1)
    by_division = np.clip(np.round(x / in_scale), -127, 127)
    by_reciprocal = np.clip(np.round(x * (np.float32(1.0) / in_scale)), -127, 127)
    assert (by_division != by_reciprocal).any()  # this input tells the two apart
    qp = {"kernel_q": np.ones((1, 1, 1, 1), np.int8), "w_scale": np.ones(1, np.float32),
          "in_scale": in_scale, "bias": np.zeros(1, np.float32)}
    want = JL.conv2d_int8(jnp.asarray(x), {n: jnp.asarray(v) for n, v in qp.items()}, 1, 1)
    got = TL.conv2d_int8(_t(x), qparams_from_jax(qp), 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), by_division * in_scale)


@pytest.mark.parametrize("k,stride,explicit_pad,cin,cout", CONVS)
def test_conv2d_int8_qact_in_qact_out_matches_jax(k, stride, explicit_pad, cin, cout):
    rng = np.random.RandomState(k * 10 + stride + 1)
    qp = _qparams(rng, k, cin, cout, chain=True)
    jx, tx = _qact(rng, (2, 9, 11, cin), 0.0413)
    want = JL.conv2d_int8(jx, {n: jnp.asarray(v) for n, v in qp.items()}, stride, 1,
                          leaky=True, explicit_pad=explicit_pad)
    got = TL.conv2d_int8(tx, qparams_from_jax(qp), stride, 1, leaky=True,
                         explicit_pad=explicit_pad)
    assert isinstance(got, TL.QAct) and got.q.dtype == torch.int8 and got.q.is_contiguous()
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert float(got.scale) == float(want.scale)


@pytest.mark.parametrize("m,k,n", [(512, 128, 256), (169, 256, 128), (1024, 64, 32)])
@pytest.mark.parametrize("leaky", [True, False])
def test_conv1x1_plain_equals_pallas_kernel(m, k, n, leaky):
    """The shapes of tests/test_pallas_conv1x1.py; int8 output bit-equal."""
    rng = np.random.RandomState(m + n)
    xq = rng.randint(-127, 128, (m, k)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.rand(n) * 1e-2).astype(np.float32)
    bias = rng.randn(n).astype(np.float32)
    inv = np.float32(17.0)
    want = JC.conv1x1_int8_requant(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                                   jnp.asarray(bias), inv, leaky=leaky, interpret=True)
    got = TC.conv1x1_int8_requant(_t(xq), _t(np.ascontiguousarray(wq.T)), _t(scale),
                                  _t(bias), torch.tensor([inv]), leaky=leaky)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv1x1_plain_fp_output_equals_pallas_kernel():
    """fp output of the shape of tests/test_pallas_conv1x1.py.

    The port's plain version is bit-equal to the int32-exact reference of
    that test (``acc·scale`` rounded, then ``+ bias`` rounded, as the CUDA
    kernel's ``__fmul_rn`` / ``__fadd_rn``). The Pallas kernel in interpret
    mode is not: XLA:CPU contracts ``acc·scale + bias`` into one fma.
    Witness (this input, leaky off): element (0, 2), acc −61540, scale
    0.005159881, bias −0.30936673 gives −317.84845 with one rounding and
    −317.84842 with two; all 4,768 of 19,200 differing elements equal the fma
    value exactly. So the Pallas tensor is held to that test's own tolerance
    (1e-6 relative + 1e-6 absolute) and to the fma reference bit for bit."""
    rng = np.random.RandomState(7)
    m, k, n = 300, 128, 64
    xq = rng.randint(-127, 128, (m, k)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.rand(n) * 1e-2).astype(np.float32)
    bias = rng.randn(n).astype(np.float32)
    pallas = np.asarray(JC.conv1x1_int8_requant(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale), jnp.asarray(bias), 1.0,
        leaky=True, out_dtype=jnp.float32, interpret=True))
    got = TC.conv1x1_int8_requant(_t(xq), _t(np.ascontiguousarray(wq.T)), _t(scale),
                                  _t(bias), None, leaky=True, out_dtype=torch.float32).numpy()
    acc = xq.astype(np.int32) @ wq.astype(np.int32)

    def leaky(y):
        return np.where(y >= 0, y, (y * np.float32(0.1)).astype(np.float32))

    two_roundings = leaky(acc.astype(np.float32) * scale + bias)
    one_rounding = leaky((acc.astype(np.float64) * scale.astype(np.float64)
                          + bias.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(got, two_roundings)
    np.testing.assert_array_equal(pallas, one_rounding)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,h,w,c,cm", [(2, 13, 13, 128, 64), (1, 7, 9, 256, 128)])
def test_fused_resblock_plain_equals_pallas_kernel(b, h, w, c, cm):
    """The shapes and scales of tests/test_pallas_resblock.py; the whole halo
    matrix (zero halo included) bit-equal."""
    rng = np.random.RandomState(c + h)
    xq = rng.randint(-127, 128, (b, h, w, c)).astype(np.int8)
    w1 = rng.randint(-127, 128, (c, cm)).astype(np.int8)
    w2 = rng.randint(-20, 21, (9, cm, c)).astype(np.int8)
    scale1 = (rng.rand(cm) * 1e-3 + 1e-4).astype(np.float32)
    bias1 = rng.randn(cm).astype(np.float32)
    scale2 = (rng.rand(c) * 1e-4 + 1e-5).astype(np.float32)
    bias2 = rng.randn(c).astype(np.float32)
    s2, s_x = np.float32(0.07273), np.float32(0.04131)
    inv1, inv2, inv_out = (np.float32(1.0 / np.float32(s)) for s in (0.05177, 0.07273, 0.06113))
    want = JR.fused_resblock(
        JR.to_halo(jnp.asarray(xq)), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(scale1),
        jnp.asarray(bias1), inv1, jnp.asarray(scale2), jnp.asarray(bias2), inv2, s2, s_x,
        inv_out, b=b, h=h, w=w, interpret=True)
    got = TR.fused_resblock(
        TR.to_halo(_t(xq)), _t(np.ascontiguousarray(w1.T)),
        _t(np.ascontiguousarray(w2.transpose(0, 2, 1))), _t(scale1), _t(bias1),
        torch.tensor(inv1), _t(scale2), _t(bias2), torch.tensor(inv2), torch.tensor(s2),
        torch.tensor(s_x), torch.tensor(inv_out), b=b, h=h, w=w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out4 = got.reshape(b, h + 2, w + 2, c)
    assert not out4[:, 0].any() and not out4[:, -1].any()
    assert not out4[:, :, 0].any() and not out4[:, :, -1].any()


def test_fused_resblock_plain_equals_unfused_chain_through_block_args():
    """``block_args`` on chain-mode quantized params: the fused block equals
    conv2d_int8 (1×1) → conv2d_int8 (3×3) → add_requant, bit for bit."""
    rng = np.random.RandomState(5)
    b, h, w, c, cm = 2, 6, 7, 64, 32
    squeeze = qparams_from_jax(_qparams(rng, 1, c, cm, chain=True))
    expand = qparams_from_jax(_qparams(rng, 3, cm, c, chain=True))
    expand["kernel_q"] = (expand["kernel_q"] // 8).contiguous()  # keeps the lattice unsaturated
    shortcut = {"out_scale": torch.tensor(0.0611)}
    _, x = _qact(rng, (b, h, w, c), 0.0413)
    a = TL.conv2d_int8(x, squeeze, 1, 1, leaky=True)
    a = TL.conv2d_int8(a, expand, 1, 1, leaky=True)
    want = TL.add_requant(x, a, shortcut["out_scale"])
    kwargs, out_scale = TR.block_args(squeeze, expand, shortcut, x.scale)
    got = TR.from_halo(TR.fused_resblock(TR.to_halo(x.q), **kwargs, b=b, h=h, w=w), b, h, w)
    assert out_scale is shortcut["out_scale"]
    assert len(torch.unique(want.q)) > 20
    np.testing.assert_array_equal(got.numpy(), want.q.numpy())


def test_packed_block_args_are_reused_per_model_and_released_with_it():
    """A block's constant kernel arguments, packed once into the params
    (``block_constants`` under ``"fused"``, as ``pack_fused_stages`` does when
    the ``int8_chain`` predictor is built), are the tensors every later
    ``block_args`` hands the kernel, equal to what unpacked params give, and
    go with the params: nothing outside the params tree keeps them."""
    import gc
    import weakref

    rng = np.random.RandomState(9)
    squeeze = qparams_from_jax(_qparams(rng, 1, 64, 32, chain=True))
    expand = qparams_from_jax(_qparams(rng, 3, 32, 64, chain=True))
    shortcut = {"out_scale": torch.tensor(0.0611)}
    s_x = torch.tensor(0.0413)
    packed = dict(squeeze, fused=TR.block_constants(squeeze, expand, shortcut))
    first, scale = TR.block_args(packed, expand, shortcut, s_x)
    again, _ = TR.block_args(packed, expand, shortcut, torch.tensor(0.0413))
    assert scale is shortcut["out_scale"]
    assert all(first[k] is packed["fused"][k] is again[k] for k in packed["fused"])
    assert set(first) == set(packed["fused"]) | {"scale1", "s_x"}
    want, _ = TR.block_args(squeeze, expand, shortcut, s_x)
    assert set(first) == set(want) and all(torch.equal(first[k], want[k]) for k in want)
    assert want["w1"].untyped_storage().data_ptr() != squeeze["kernel_q"].untyped_storage(
        ).data_ptr()
    gone = weakref.ref(packed["fused"]["w2"])
    del packed, first, again
    gc.collect()
    assert gone() is None


def test_halo_round_trip_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randint(-127, 128, (3, 5, 6, 32)).astype(np.int8)
    xp = TR.to_halo(_t(x))
    assert tuple(xp.shape) == (3 * 7 * 8, 32)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(JR.to_halo(jnp.asarray(x))))
    np.testing.assert_array_equal(TR.from_halo(xp, 3, 5, 6).numpy(), x)
    np.testing.assert_array_equal(TR.halo_mask(5, 6), JR.halo_mask(5, 6))


def test_resblock_plan_fits_shared_memory_at_the_darknet_stages():
    for hw, c in ((208, 64), (104, 128), (52, 256), (26, 512), (13, 1024)):
        p = TR.plan(16, hw, hw, c, c // 2)
        rows, slice_cols = p["band_rows"], p["slice_cols"]
        assert 1 <= rows <= hw and c % slice_cols == 0 and slice_cols % p["bn2"] == 0
        # the ring of the larger of the squeeze's and the expand's slots, the
        # output stage, then the q1 band: (rows + 2) image rows of W + 2
        # pixels and two more
        ring = max(4 * (128 + p["bn1"]) * 128, 6 * p["bn2"] * 128) + 1024
        stage = 128 * (p["bn2"] + 16)
        assert p["smem"] == ring + stage + ((rows + 2) * (hw + 2) + 2) * (c // 2 + 16) <= 232448
