"""The port's CUDA kernels (yolov3_tpu_torch/ops/cuda/) against their plain
PyTorch versions, on an NVIDIA card. Marked ``cuda``; each test skips
without a card (the kernels have no CPU mode). This file imports neither
JAX nor the JAX package, so on a machine with the card and no JAX it runs
alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Inputs are made with numpy from a seed. Tolerance: none, except K5's and
K7's sums and the train step through K7 (stated at their tests). K8 (the
folded conv's bias and activation) is held bit for bit against the plain
expression evaluated by PyTorch on the card."""

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.models import layers as L
from yolov3_tpu_torch.ops.cuda import (bias_act, bn_leaky, bn_stats, conv1x1, conv_int8,
                                       nms_kernel, resblock, round_sweep)


def _sweep_case(seed, b, k, valid_frac=0.6, thr=0.7):
    rng = np.random.RandomState(seed)
    iou = rng.rand(b, k, k).astype(np.float32)
    iou = (iou + iou.transpose(0, 2, 1)) / 2
    mat = iou > thr
    valid = rng.rand(b, k) < valid_frac
    return mat, valid


def _boxes_case(seed, b, n):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2) * 0.8
    wh = rng.rand(b, n, 2) * 0.3 + 0.02
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, n // 8] = boxes[:, n // 16]  # exact duplicate boxes …
    scores = (np.round(rng.rand(b, n) * 40) / 40).astype(np.float32)  # … and score ties
    scores[:, n // 8] = scores[:, n // 16]
    return boxes, scores


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(4, 100), (1, 512), (4, 512), (16, 512), (3, 1299), (3, 1300),
                                 (4, 33)])
def test_cuda_sweep_equals_plain(cuda_device, b, k):
    """K1 up to its largest K (1300, the packed matrix in shared memory),
    ragged K, a dense and a sparse mask. Tolerance: none — keep masks
    bit-equal to the plain version."""
    for thr in (0.7, 0.97):
        mat, valid = _sweep_case(k, b, k, thr=thr)
        mat_t = torch.from_numpy(mat).to(cuda_device)
        valid_t = torch.from_numpy(valid).to(cuda_device)
        before = nms_kernel.suppression_sweep.launches
        got = nms_kernel.suppression_sweep(mat_t, valid_t)
        torch.cuda.synchronize()
        assert nms_kernel.suppression_sweep.launches == before + 1
        want = nms_kernel.suppression_sweep_ref(mat_t, valid_t)
        assert torch.equal(got, want) and bool(want.any())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [512, 1300])
def test_cuda_sweep_chain_dense_and_empty(cuda_device, k):
    """Each box suppressing the next (every other one kept), one box
    suppressing all, nothing valid. Tolerance: none."""
    chain = torch.from_numpy(np.eye(k, k, 1, dtype=bool)[None].repeat(2, 0)).to(cuda_device)
    dense = torch.ones((2, k, k), dtype=torch.bool, device=cuda_device)
    every = torch.ones((2, k), dtype=torch.bool, device=cuda_device)
    none = torch.zeros((2, k), dtype=torch.bool, device=cuda_device)
    alternate = (torch.arange(k, device=cuda_device) % 2 == 0).expand(2, k)
    got = nms_kernel.suppression_sweep(chain, every)
    torch.cuda.synchronize()
    assert torch.equal(got, alternate)
    got = nms_kernel.suppression_sweep(dense, every)
    assert int(got.sum()) == 2 and bool(got[:, 0].all())
    assert not bool(nms_kernel.suppression_sweep(dense, none).any())


@pytest.mark.cuda
def test_cuda_sweep_raises_above_its_bound(cuda_device):
    """K1 takes K up to ``MAX_SWEEP_K`` (its packed matrix in one block's
    shared memory) and raises above it, launching nothing."""
    k = nms_kernel.MAX_SWEEP_K + 1
    before = nms_kernel.suppression_sweep.launches
    with pytest.raises(ValueError, match="exceeds"):
        nms_kernel.suppression_sweep(torch.zeros((1, k, k), dtype=torch.bool, device=cuda_device),
                                     torch.zeros((1, k), dtype=torch.bool, device=cuda_device))
    assert nms_kernel.suppression_sweep.launches == before


@pytest.mark.cuda
def test_cuda_matrix_bound_override_above_k1_raises(cuda_device, monkeypatch):
    """A ``YOLOV3_NMS_MATRIX_MAX_K`` above K1's bound sends such a K to the
    matrix branch, where K1 raises: ``yolo_nms`` never falls back to the
    plain sweep on the card."""
    from yolov3_tpu_torch.ops import nms

    monkeypatch.setattr(nms, "_MATRIX_SWEEP_MAX_K", 2048)
    boxes, scores = _boxes_case(5, 1, 2000)
    boxes_t = torch.from_numpy(boxes).to(cuda_device)
    conf = torch.from_numpy(scores).to(cuda_device)[..., None]
    probs = torch.ones((1, 2000, 1), device=cuda_device)
    with pytest.raises(ValueError, match="YOLOV3_NMS_MATRIX_MAX_K"):
        nms.yolo_nms(boxes_t, conf, probs, num_candidates=nms_kernel.MAX_SWEEP_K + 200)


@pytest.mark.cuda
@pytest.mark.parametrize("n,max_boxes,score_t", [(10647, 100, 0.004), (22743, 100, 0.3),
                                                 (777, 50, 0.0)])
def test_cuda_round_sweep_equals_plain(cuda_device, n, max_boxes, score_t):
    """Tolerance: none — identical indices (the kernel's IoU rounds as the
    plain element-wise ops do)."""
    boxes, scores = _boxes_case(n, 3, n)
    bt = torch.from_numpy(boxes).to(cuda_device)
    st = torch.from_numpy(scores).to(cuda_device)
    sel, nv = round_sweep.round_sweep(bt, st, 0.5, score_t, max_boxes=max_boxes)
    torch.cuda.synchronize()
    want_sel, want_nv = round_sweep.round_sweep_ref(bt, st, 0.5, score_t, max_boxes)
    assert torch.equal(sel, want_sel) and torch.equal(nv, want_nv)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,score_t,cluster", [
    (16, 10647, 0.004, 8), (16, 22743, 0.004, 8), (4, 10647, 0.004, 16), (4, 22743, 0.004, 16),
    (1, 10647, 0.004, 16), (1, 22743, 0.004, 16), (64, 10647, 0.004, 2), (2, 100000, 0.3, 16),
    (3, 300, 0.0, 16), (5, 40, 0.97, 16)])
def test_cuda_round_sweep_clusters_equal_plain(cuda_device, b, n, score_t, cluster):
    """K2 at every cluster size its plan takes (B = 16: 8 blocks an image;
    B = 1, 4: 16; B = 64: 2; 100,000 boxes: 16 blocks of 150 KB), with exact
    duplicate boxes and score ties, and images that run out of live boxes
    before 100 rounds. Tolerance: none — identical indices and counts."""
    assert round_sweep.plan(b, n)["cluster"] == cluster
    boxes, scores = _boxes_case(n + b, b, n)
    bt = torch.from_numpy(boxes).to(cuda_device)
    st = torch.from_numpy(scores).to(cuda_device)
    before = round_sweep.round_sweep.launches
    sel, nv = round_sweep.round_sweep(bt, st, 0.5, score_t, max_boxes=100)
    torch.cuda.synchronize()
    assert round_sweep.round_sweep.launches == before + 1
    want_sel, want_nv = round_sweep.round_sweep_ref(bt, st, 0.5, score_t, 100)
    assert torch.equal(sel, want_sel) and torch.equal(nv, want_nv)


@pytest.mark.cuda
def test_cuda_round_floor_probe_runs(cuda_device):
    """The latency floor's probe (``kernel_times.round_floor``, built apart
    from the kernels) launches at the B = 16 and B = 1 shapes and leaves its
    checksum: every block folded the same winner each round."""
    from yolov3_tpu_torch.ops.cuda.kernel_times import round_floor

    for b in (16, 1):
        sink = round_floor(b, 10647, 100)
        torch.cuda.synchronize()
        assert int(sink.min()) == int(sink.max())


def _epilogue(rng, n, device, scale_max):
    scale = torch.from_numpy((rng.rand(n) * scale_max).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.randn(n).astype(np.float32)).to(device)
    return scale, bias, torch.tensor([17.3], dtype=torch.float32, device=device)


def _int8(rng, shape, device, lim=127):
    return torch.from_numpy(rng.randint(-lim, lim + 1, shape).astype(np.int8)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 64, 32), (169, 256, 128), (1000, 27, 16),
                                   (257, 48, 255), (129, 80, 65)])
@pytest.mark.parametrize("leaky", [True, False])
@pytest.mark.parametrize("out_dtype", [torch.int8, torch.float32])
def test_cuda_conv1x1_int8_equals_plain(cuda_device, m, k, n, leaky, out_dtype):
    """K3 on ragged M, K and N. Tolerance: none — integer sums, and an
    epilogue that rounds where the plain version's element-wise ops do."""
    rng = np.random.RandomState(m + n)
    x, w = _int8(rng, (m, k), cuda_device), _int8(rng, (n, k), cuda_device)
    scale, bias, inv = _epilogue(rng, n, cuda_device, 1e-4)
    before = conv1x1.conv1x1_int8_requant.launches
    got = conv1x1.conv1x1_int8_requant(x, w, scale, bias, inv, leaky=leaky,
                                       out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert conv1x1.conv1x1_int8_requant.launches == before + 1
    want = conv1x1.conv1x1_int8_requant_plain(x, w, scale, bias, inv, leaky=leaky,
                                              out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


# (M, Cin, Cout): each path and plan branch of K3 at the main path's sizes
# and on ragged edges
K3_CASES = [
    (692224, 64, 32),    # 208² 64→32 at B=16: persistent, m64n32k32, four blocks an SM
    (173056, 128, 64),   # 104² 128→64 at B=16: persistent, three blocks an SM
    (2704, 1024, 512),   # 13² at B=16: 128×32 tiles, eight k-tiles
    (169, 1024, 512),    # 13² at B=1: 32 blocks
    (43227, 256, 128),   # ragged M, 128×64 tiles, two k-tiles
    (77, 16, 100),       # persistent BN=128, one k32 product half zero-filled, ragged N
    (131, 112, 40),      # persistent, K = 3.5 k32 products
    (5, 144, 200),       # tiled, ragged K (a k-tile of 16), ragged N
    (300, 2048, 24),     # tiled 128×32 with N % 16 = 8 (byte stores of int8)
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", K3_CASES)
def test_cuda_conv1x1_int8_paths_equal_plain(cuda_device, m, k, n):
    """K3 on its persistent and tiled wgmma paths, int8 and f32 output,
    leaky on and off, one launch a call, and the kernel the plan names
    (read off the profiled kernel's name). Tolerance: none."""
    rng = np.random.RandomState(m + k + n)
    x, w = _int8(rng, (m, k), cuda_device), _int8(rng, (n, k), cuda_device)
    scale, bias, inv = _epilogue(rng, n, cuda_device, 2e-4)
    for out_dtype in (torch.int8, torch.float32):
        plan = conv1x1.plan(m, k, n, out_dtype)
        for leaky in (True, False):
            before = conv1x1.conv1x1_int8_requant.launches
            got = conv1x1.conv1x1_int8_requant(x, w, scale, bias, inv, leaky=leaky,
                                               out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert conv1x1.conv1x1_int8_requant.launches == before + 1
            want = conv1x1.conv1x1_int8_requant_plain(x, w, scale, bias, inv, leaky=leaky,
                                                      out_dtype=out_dtype)
            assert got.dtype == out_dtype and torch.equal(got, want), (plan, leaky)
        names = _device_kernels(lambda: conv1x1.conv1x1_int8_requant(
            x, w, scale, bias, inv, leaky=True, out_dtype=out_dtype))
        if names:  # the profiler may show no device activity on some machines
            assert len(names) == 1 and f"conv1x1_int8_{plan['path']}_kernel" in names[0], names
    assert len(torch.unique(got)) > 50


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout,k,stride,pad", [
    (2, 9, 11, 16, 24, 3, 1, ((1, 1), (1, 1))),      # 3×3 s1 SAME
    (2, 13, 10, 48, 64, 3, 2, ((1, 0), (1, 0))),     # 3×3 s2, Darknet top-left pad
    (1, 12, 14, 3, 40, 4, 2, ((1, 2), (1, 2))),      # the s2d stem's conv0, Cin = 3
    (2, 11, 9, 32, 20, 2, 1, ((1, 0), (1, 0))),      # the s2d stem's conv1
    (2, 10, 10, 3, 16, 3, 1, ((1, 1), (1, 1))),      # an un-rewritten stem conv, K = 27
    (1, 7, 7, 20, 130, 3, 1, ((1, 1), (1, 1))),      # Cin not a multiple of 16
])
@pytest.mark.parametrize("out_dtype", [torch.int8, torch.float32])
def test_cuda_conv_int8_equals_plain(cuda_device, b, h, w, cin, cout, k, stride, pad,
                                     out_dtype):
    """K6. Tolerance: none."""
    rng = np.random.RandomState(cin * cout + k)
    x, kq = _int8(rng, (b, h, w, cin), cuda_device), _int8(rng, (cout, k, k, cin), cuda_device)
    scale, bias, inv = _epilogue(rng, cout, cuda_device, 1e-5)
    before = conv_int8.conv_int8.launches
    got = conv_int8.conv_int8(x, kq, scale, bias, inv, stride=stride, padding=pad,
                              leaky=True, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert conv_int8.conv_int8.launches == before + 1
    want = conv_int8.conv_int8_plain(x, kq, scale, bias, inv, stride=stride, padding=pad,
                                     leaky=True, out_dtype=out_dtype)
    assert tuple(got.shape) == tuple(want.shape) and torch.equal(got, want)


# every non-1×1 conv shape class of YOLOv3-416: (hw, cin, cout, stride)
K6_YOLOV3_CLASSES = [(416, 32, 64, 2), (208, 64, 128, 2), (104, 128, 256, 2), (52, 256, 512, 2),
                     (26, 512, 1024, 2), (208, 32, 64, 1), (104, 64, 128, 1), (52, 128, 256, 1),
                     (26, 256, 512, 1), (13, 512, 1024, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw,cin,cout,stride", K6_YOLOV3_CLASSES)
@pytest.mark.parametrize("b", [1, 4, 16])
def test_cuda_conv_int8_yolov3_shapes_equal_plain(cuda_device, hw, cin, cout, stride, b):
    """K6 at full width at every 3×3 shape class of YOLOv3-416 (each stage,
    stride 1 and 2), batch buckets 1, 4 and 16, int8 and f32 output: the
    wgmma path with and without the split contraction. Tolerance: none."""
    rng = np.random.RandomState(hw + cout + b)
    x, kq = _int8(rng, (b, hw, hw, cin), cuda_device), _int8(rng, (cout, 3, 3, cin), cuda_device)
    scale, bias, inv = _epilogue(rng, cout, cuda_device, 2e-5)
    pad = ((1, 1), (1, 1)) if stride == 1 else ((1, 0), (1, 0))
    ho = conv_int8.out_size(hw, 3, stride, pad[0])
    assert conv_int8.plan(b * ho * ho, cin, cout, 9 * cin)["path"] == "wgmma"
    for out_dtype in (torch.int8, torch.float32):
        got = conv_int8.conv_int8(x, kq, scale, bias, inv, stride=stride, padding=pad,
                                  leaky=True, out_dtype=out_dtype)
        torch.cuda.synchronize()
        want = conv_int8.conv_int8_plain(x, kq, scale, bias, inv, stride=stride, padding=pad,
                                         leaky=True, out_dtype=out_dtype)
        assert tuple(got.shape) == (b, ho, ho, cout) and torch.equal(got, want)
        del got, want
    assert len(torch.unique(conv_int8.conv_int8(x, kq, scale, bias, inv, stride=stride,
                                                padding=pad, leaky=True))) > 50


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout,k,stride,pad", [
    (3, 7, 5, 64, 200, 3, 1, ((1, 1), (1, 1))),      # ragged M (105) and N (200 = 128 + 72)
    (1, 5, 5, 32, 136, 3, 1, ((1, 1), (1, 1))),      # N % 16 = 8: byte stores of int8
    (2, 9, 9, 16, 7, 3, 1, ((1, 1), (1, 1))),        # odd N, K = 144 (one full k-tile + 16)
    (1, 13, 13, 512, 1000, 3, 1, ((1, 1), (1, 1))),  # split contraction with a ragged N
    (5, 6, 7, 80, 72, 5, 2, ((2, 1), (2, 1))),       # 5×5 s2, Cin = 80: taps change mid-tile
    (2, 8, 8, 1040, 48, 1, 1, ((0, 0), (0, 0))),     # 1×1 through K6, Cin > 1024
])
@pytest.mark.parametrize("out_dtype", [torch.int8, torch.float32])
def test_cuda_conv_int8_wgmma_ragged_equals_plain(cuda_device, b, h, w, cin, cout, k, stride,
                                                  pad, out_dtype):
    """K6's wgmma path on ragged M, N and contraction ends. Tolerance: none."""
    rng = np.random.RandomState(cin + cout + k)
    x, kq = _int8(rng, (b, h, w, cin), cuda_device), _int8(rng, (cout, k, k, cin), cuda_device)
    scale, bias, inv = _epilogue(rng, cout, cuda_device, 1e-5)
    for leaky in (True, False):
        got = conv_int8.conv_int8(x, kq, scale, bias, inv, stride=stride, padding=pad,
                                  leaky=leaky, out_dtype=out_dtype)
        torch.cuda.synchronize()
        want = conv_int8.conv_int8_plain(x, kq, scale, bias, inv, stride=stride, padding=pad,
                                         leaky=leaky, out_dtype=out_dtype)
        assert tuple(got.shape) == tuple(want.shape) and torch.equal(got, want)


def _resblock_args(rng, b, h, w, c, cm, device):
    xp = resblock.to_halo(_int8(rng, (b, h, w, c), device))
    w1, w2 = _int8(rng, (cm, c), device), _int8(rng, (9, c, cm), device, 20)
    scale1, bias1, _ = _epilogue(rng, cm, device, 1e-3)
    scale2, bias2, _ = _epilogue(rng, c, device, 1e-4)
    s = [torch.tensor(v, dtype=torch.float32, device=device)
         for v in (1 / 0.05177, 1 / 0.07273, 0.07273, 0.04131, 1 / 0.06113)]
    return (xp, w1, w2, scale1, bias1, s[0], scale2, bias2, s[1], s[2], s[3], s[4])


def _check_resblock(args, b, h, w):
    before = resblock.fused_resblock.launches
    got = resblock.fused_resblock(*args, b=b, h=h, w=w)
    torch.cuda.synchronize()
    assert resblock.fused_resblock.launches == before + 1
    want = resblock.fused_resblock_plain(*args, b=b, h=h, w=w)
    assert torch.equal(got, want) and len(torch.unique(got)) > 20


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,cm,tiles", [
    (2, 13, 13, 128, 64, (64, 128)), (1, 7, 9, 256, 128, (128, 128)),
    (3, 5, 6, 64, 32, (32, 64)), (2, 30, 17, 96, 48, (64, 128)), (3, 40, 21, 64, 32, (32, 64)),
    (1, 6, 50, 512, 256, (128, 128)), (2, 9, 11, 160, 80, (64, 128)),
    (2, 11, 13, 128, 128, (128, 128))])
def test_cuda_fused_resblock_equals_plain(cuda_device, b, h, w, c, cm, tiles):
    """K4 on each of the three pairs of tile widths (squeeze over Cm, expand
    over C) it is built for, over several bands and channel slices, ragged
    Cm (48, 80: a 16-byte chunk of the tap-major contraction is the last of
    its tap).
    Tolerance: none — the whole halo matrix, zero ring included."""
    pl = resblock.plan(b, h, w, c, cm)
    assert (pl["bn1"], pl["bn2"]) == tiles
    _check_resblock(_resblock_args(np.random.RandomState(c + h), b, h, w, c, cm, cuda_device),
                    b, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c", [(208, 64), (104, 128), (52, 256), (26, 512), (13, 1024)])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_cuda_fused_resblock_darknet_stages_equal_plain(cuda_device, hw, c, b):
    """K4 at the five residual stages of Darknet-53 at 416² (C = 64 … 1024,
    Cm = C/2) for the serving buckets B = 1, 4 and 16. Tolerance: none."""
    _check_resblock(_resblock_args(np.random.RandomState(c + b), b, hw, hw, c, c // 2,
                                   cuda_device), b, hw, hw)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,rows", [(52, 256, 28), (52, 256, 24), (13, 1024, 7),
                                       (13, 1024, 6), (208, 64, 112)])
@pytest.mark.parametrize("flags", [(True, False), (False, True), (True, True)])
def test_cuda_fused_resblock_band_edges_equal_plain(cuda_device, hw, c, rows, flags):
    """K4 on one band of a spatial split (``rows`` of an ``hw``-row stage at
    416², B = 2) whose top / bottom halo row holds a neighbour's pixels
    (``halo_top``, ``halo_bottom``): bit-equal to the plain version with the
    same flags, and the flags change the output (the band's edge rows read
    the neighbour's squeeze). Tolerance: none."""
    b, top, bottom = 2, *flags
    args = _resblock_args(np.random.RandomState(c + rows), b, rows, hw, c, c // 2, cuda_device)
    before = resblock.fused_resblock.launches
    got = resblock.fused_resblock(*args, b=b, h=rows, w=hw, halo_top=top, halo_bottom=bottom)
    torch.cuda.synchronize()
    assert resblock.fused_resblock.launches == before + 1
    want = resblock.fused_resblock_plain(*args, b=b, h=rows, w=hw, halo_top=top,
                                         halo_bottom=bottom)
    assert torch.equal(got, want)
    assert not torch.equal(got, resblock.fused_resblock_plain(*args, b=b, h=rows, w=hw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cuts", [((2, 64, 52, 52), (28, 24)), ((4, 256, 13, 13), (7, 6)),
                                        ((2, 32, 96, 20), (32, 32, 32))])
def test_cuda_bn_moments_over_bands_equal_plain(cuda_device, shape, cuts):
    """K5 over the bands of one activation (``bn_moments_bands``): one
    launch a band forward and one backward; mean and var within K5's sum
    tolerance of the plain band version (``SUM_RTOL`` of the moments'
    scale), dx bit-equal to the plain dx at the same mean and count."""
    x = _activation(7, shape, torch.float32, False, cuda_device)
    bands = [part.contiguous().requires_grad_(True) for part in x.split(cuts, dim=2)]
    before = (bn_stats.bn_sums.launches, bn_stats.bn_moments_dx.launches)
    mean, var = bn_stats.bn_moments_bands(bands)
    w = torch.from_numpy(np.random.RandomState(3).randn(2, shape[1]).astype(np.float32))
    (mean @ w[0].to(cuda_device) + var @ w[1].to(cuda_device)).backward()
    torch.cuda.synchronize()
    assert (bn_stats.bn_sums.launches, bn_stats.bn_moments_dx.launches) == (
        before[0] + len(cuts), before[1] + len(cuts))
    plain = [part.detach().clone().requires_grad_(True) for part in bands]
    pm, pv = bn_stats.bn_moments_bands_plain(plain)
    (pm @ w[0].to(cuda_device) + pv @ w[1].to(cuda_device)).backward()
    scale = float((x.float() ** 2).mean())
    assert float((mean - pm).abs().max()) <= bn_stats.SUM_RTOL * scale ** 0.5 * 10
    assert float((var - pv).abs().max()) <= bn_stats.SUM_RTOL * scale * 10
    n = x.numel() // shape[1]
    for band in bands:  # d(loss)/d(mean, var) = w[0], w[1]
        want = bn_stats.bn_moments_dx_plain(band.detach(), mean.detach(), w[0].to(cuda_device),
                                            w[1].to(cuda_device), n)
        assert torch.equal(band.grad, want)


def _activation(seed, shape, dtype, channels_last, device):
    """A (B, C, H, W) activation with a mean well off zero in some channels
    and one constant channel, in the asked memory format."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) * 2 + rng.randn(1, shape[1], 1, 1) * 3
    x[:, 0] = 1.5
    t = torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=dtype)
    return t.contiguous(memory_format=torch.channels_last) if channels_last else t.contiguous()


BN_SHAPES = [(3, 32, 5, 7), (2, 64, 26, 26), (4, 256, 13, 13), (2, 1024, 4, 4), (2, 40, 9, 11),
             (1, 3, 8, 8), (2, 32, 104, 104)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
def test_cuda_bn_sums_against_float64(cuda_device, shape, dtype, channels_last):
    """K5 forward. Tolerance: ``SUM_RTOL`` (1e-5) of Σ|x| and of Σx² against
    float64 (another order of summation than the plain version's); two
    launches bit-identical; the plain version inside the same tolerance."""
    x = _activation(sum(shape), shape, dtype, channels_last, cuda_device)
    before = bn_stats.bn_sums.launches
    s, q = bn_stats.bn_sums(x)
    torch.cuda.synchronize()
    assert bn_stats.bn_sums.launches == before + 1
    s_again, q_again = bn_stats.bn_sums(x)
    assert torch.equal(s, s_again) and torch.equal(q, q_again)
    x64 = x.double()
    ref_s, ref_q = x64.sum(dim=(0, 2, 3)), (x64 * x64).sum(dim=(0, 2, 3))
    scale_s = x64.abs().sum(dim=(0, 2, 3))
    for got_s, got_q in ((s, q), bn_stats.bn_sums_plain(x)):
        assert float(((got_s.double() - ref_s).abs() / scale_s).max()) <= bn_stats.SUM_RTOL
        assert float(((got_q.double() - ref_q).abs() / ref_q).max()) <= bn_stats.SUM_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
def test_cuda_bn_moments_backward_equals_plain(cuda_device, shape, dtype, channels_last):
    """K5 backward through autograd. Tolerance: none — ``a·x + b`` rounds in
    the kernel where the plain version's element-wise ops do; dx keeps x's
    dtype and memory format. The moments themselves: 1e-5 relative to
    max(|mean|, 1) and max(var, 1) (they inherit the sums' tolerance)."""
    x = _activation(sum(shape) + 1, shape, dtype, channels_last, cuda_device)
    rng = np.random.RandomState(0)
    wm = torch.from_numpy(rng.randn(shape[1]).astype(np.float32)).to(cuda_device)
    wv = torch.from_numpy(rng.randn(shape[1]).astype(np.float32)).to(cuda_device)
    grads, moments = [], []
    before = bn_stats.bn_moments_dx.launches
    for fn in (bn_stats.bn_moments, bn_stats.bn_moments_plain):
        xi = x.clone(memory_format=torch.preserve_format).requires_grad_(True)
        mean, var = fn(xi)
        ((mean * wm).sum() + (var * wv).sum()).backward()
        grads.append(xi.grad)
        moments.append((mean.detach(), var.detach()))
    torch.cuda.synchronize()
    assert bn_stats.bn_moments_dx.launches == before + 1
    assert grads[0].dtype == dtype and grads[0].stride() == x.stride()
    # the two forwards differ within the sums' tolerance, so feed both
    # backwards the same mean before asking for equal bits
    mean = moments[0][0]
    assert torch.equal(bn_stats.bn_moments_dx(x, mean, wm, wv),
                       bn_stats.bn_moments_dx_plain(x, mean, wm, wv))
    for got, want in zip(moments[0], moments[1]):
        assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()) <= 1e-5
    assert float(moments[0][1][0]) < 1e-3  # the constant channel's variance


@pytest.mark.cuda
def test_cuda_bn_stats_raises_on_what_it_does_not_take(cuda_device):
    x = torch.zeros((2, 8, 6, 6), device=cuda_device)
    with pytest.raises(ValueError, match="dense channels-last or NCHW"):
        bn_stats.bn_sums(x[:, :, ::2])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bn_stats.bn_sums(x.half())
    with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
        bn_stats.bn_sums(x[0])


def _device_kernels(fn):
    """Names of the kernels one call of ``fn`` ran on the device (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]


def _moments_on_card(x):
    """The plain expression of (mean, var) evaluated on the card from K5's own sums."""
    n = x.numel() // x.shape[1]
    s, q = bn_stats.bn_sums(x)
    mean = s / n
    return mean, torch.clamp(q / n - mean * mean, min=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BN_SHAPES + [(16, 256, 52, 52)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
def test_cuda_bn_moments_one_launch_and_equal_bits(cuda_device, shape, dtype, channels_last):
    """K5's forward and backward are one device launch each, and the kernel's
    mean and var are bit-equal to ``sum / n`` and ``clamp(sumsq / n − mean²,
    0)`` evaluated by PyTorch on the card from the kernel's sums. Tolerance:
    none."""
    x = _activation(sum(shape) + 2, shape, dtype, channels_last, cuda_device)
    with torch.no_grad():
        mean, var = bn_stats.bn_moments(x)
        want_mean, want_var = _moments_on_card(x)
    assert torch.equal(mean, want_mean) and torch.equal(var, want_var)
    assert float(var[0]) == 0.0 or float(var[0]) < 1e-3
    with torch.no_grad():
        names = _device_kernels(lambda: bn_stats.bn_moments(x))
    if names:  # the profiler may show no device activity on some machines
        assert len(names) == 1 and "bn_moments_" in names[0], names
    dmean, dvar = torch.randn_like(mean), torch.randn_like(var)
    names = _device_kernels(lambda: bn_stats.bn_moments_dx(x, mean, dmean, dvar))
    if names:
        assert len(names) == 1 and "bn_dx_kernel" in names[0], names


@pytest.mark.cuda
def test_cuda_bn_moments_two_streams_and_workspace_growth(cuda_device):
    """Two calls on two streams at once each get their own workspace and the
    right answer; a shape that needs a larger workspace after a smaller one
    on the same stream is right too, and so is the smaller one again."""
    small = _activation(1, (2, 32, 104, 104), torch.float32, False, cuda_device)
    large = _activation(2, (16, 1024, 26, 52), torch.float32, False, cuda_device)
    assert bn_stats._plan(False, 16, 1024, 26 * 52)[0] > 1  # it folds partial rows
    want = {}
    for name, x in (("small", small), ("large", large)):
        want[name] = [t.clone() for t in bn_stats.bn_moments(x)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for _ in range(20):
        for i, (stream, x) in enumerate(zip(streams, (large, small))):
            with torch.cuda.stream(stream):
                got[i].append(bn_stats.bn_moments(x))
    torch.cuda.synchronize()
    keys = {k for k in bn_stats._workspaces if k[1] in {s.cuda_stream for s in streams}}
    assert len(keys) == 2
    for i, name in enumerate(("large", "small")):
        for mean, var in got[i]:
            assert torch.equal(mean, want[name][0]) and torch.equal(var, want[name][1])
    # growth on one stream: small, then a shape whose partial rows need more
    with torch.cuda.stream(torch.cuda.Stream()) as _:
        stream = torch.cuda.current_stream().cuda_stream
        first = bn_stats.bn_moments(small)
        words = bn_stats._workspaces[(small.device.index, stream)].numel()
        huge = _activation(3, (2, 2048, 64, 64), torch.float32, True, cuda_device)
        p = bn_stats._plan(True, 2, 2048, 64 * 64)[0]
        assert bn_stats._WORKSPACE_HEAD + p * 2 * 2048 > words
        grown = bn_stats.bn_moments(huge)
        again = bn_stats.bn_moments(small)
        assert bn_stats._workspaces[(small.device.index, stream)].numel() > words
        want_huge = _moments_on_card(huge)
    torch.cuda.synchronize()
    assert torch.equal(first[0], want["small"][0]) and torch.equal(again[1], want["small"][1])
    assert torch.equal(grown[0], want_huge[0]) and torch.equal(grown[1], want_huge[1])
    ref = huge.double().mean(dim=(0, 2, 3))
    assert float((grown[0].double() - ref).abs().max()) <= 1e-5


# K7: (C, H) of every BatchNorm conv's output in YOLOv3-416 and YOLOv3-tiny at
# B=2, then shapes on the one-element paths (C or H·W no multiple of a vector)
K7_SHAPES = [(2, c, h, h) for c, h in (
    (16, 416), (32, 416), (32, 208), (64, 208), (64, 104), (128, 104), (128, 52), (256, 52),
    (128, 26), (256, 26), (512, 26), (128, 13), (256, 13), (512, 13), (1024, 13))] + [
    (3, 40, 9, 11), (2, 3, 8, 8), (2, 24, 5, 5)]
EPS, SLOPE = L.BN_EPS, L.LEAKY_SLOPE


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _k7_case(seed, shape, dtype, channels_last, device):
    """x (``_activation``: one constant channel, beta 0 there), dy in x's
    memory format, K5's statistics of x, gamma and beta in x's dtype."""
    x = _activation(seed, shape, dtype, channels_last, device)
    with torch.no_grad():
        mean, var = bn_stats.bn_moments(x)
    rng = np.random.RandomState(seed + 1)
    c = shape[1]
    gamma = torch.from_numpy(rng.uniform(0.8, 1.2, c).astype(np.float32)).to(device, dtype)
    beta = torch.from_numpy(rng.uniform(-0.2, 0.2, c).astype(np.float32)).to(device, dtype)
    beta[0] = 0
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype).contiguous(
        memory_format=fmt)
    return x, dy, mean, var, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K7_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
def test_cuda_bn_leaky_forward_bit_equal_to_the_expression(cuda_device, shape, dtype,
                                                           channels_last):
    """K7's forward, one launch, against training BatchNorm's plain
    expression and then LeakyReLU evaluated by PyTorch on the card
    (``layers.batch_norm`` off its K7 route, ``layers.leaky_relu``).
    Tolerance: none, bit for bit; y in x's memory format; two launches give
    the same bits."""
    x, _, mean, var, gamma, beta = _k7_case(sum(shape), shape, dtype, channels_last, cuda_device)
    before = bn_leaky.bn_leaky.launches
    with torch.no_grad():
        y = bn_leaky.bn_leaky(x, mean, var, gamma, beta, EPS, SLOPE)
        again = bn_leaky.bn_leaky(x, mean, var, gamma, beta, EPS, SLOPE)
        plain, _ = L.batch_norm(x, {"gamma": gamma, "beta": beta}, {"mean": mean, "var": var},
                                train=True, moments=(mean, var))
        want = L.leaky_relu(plain)
    torch.cuda.synchronize()
    assert bn_leaky.bn_leaky.launches == before + 2
    assert y.dtype == dtype and y.stride() == x.stride()
    assert torch.equal(_bits(y), _bits(want)) and torch.equal(_bits(y), _bits(again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K7_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
def test_cuda_bn_leaky_backward_against_plain_and_float64(cuda_device, shape, dtype,
                                                          channels_last):
    """K7's backward, one launch: dx bit-equal to the plain version on the
    card, in x's memory format; two launches the same bits in all five
    outputs. dmean, dvar, dgamma and dbeta against their formulas over
    float64 sums of the same terms: ``SUM_RTOL`` of the sums' Σ|term| (as
    K5's sums), plus 2^-21 of the value for the finishing products and, for
    bf16 parameters, 2^-8 for their rounding."""
    x, dy, mean, var, gamma, beta = _k7_case(sum(shape) + 3, shape, dtype, channels_last,
                                             cuda_device)
    before = (bn_leaky.bn_leaky_dx.launches, bn_leaky.bn_leaky_dx.dy_copies)
    got = bn_leaky.bn_leaky_dx(x, dy, mean, var, gamma, beta, EPS, SLOPE)
    again = bn_leaky.bn_leaky_dx(x, dy, mean, var, gamma, beta, EPS, SLOPE)
    want = bn_leaky.bn_leaky_dx_plain(x, dy, mean, var, gamma, beta, EPS, SLOPE)
    torch.cuda.synchronize()
    assert (bn_leaky.bn_leaky_dx.launches, bn_leaky.bn_leaky_dx.dy_copies) == (
        before[0] + 2, before[1])
    assert got[0].dtype == dtype and got[0].stride() == x.stride()
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, again))
    assert [t.dtype for t in got[1:]] == [torch.float32, torch.float32, dtype, dtype]
    view = (1, -1, 1, 1)
    r = torch.rsqrt(var + EPS)
    s = (gamma.float() * r).to(dtype)
    d = x - mean.to(dtype).view(view)
    v = d * s.view(view) + beta.to(dtype).view(view)
    g = torch.where(v >= 0, dy.float(), dy.float() * SLOPE).double()
    gd = g * d.double()
    s0, s1 = g.sum(dim=(0, 2, 3)), gd.sum(dim=(0, 2, 3))
    a0, a1 = g.abs().sum(dim=(0, 2, 3)), gd.abs().sum(dim=(0, 2, 3))
    r64, s64, gamma64 = r.double(), s.double(), gamma.double()
    rounding = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    for value, ref, scale, rnd in (
            (got[1], -s64 * s0, a0 * s64.abs(), 0.0),
            (got[2], -0.5 * s1 * gamma64 * r64 ** 3, a1 * 0.5 * gamma64 * r64 ** 3, 0.0),
            (got[3], s1 * r64, a1 * r64, rounding), (got[4], s0, a0, rounding)):
        err = (value.double() - ref).abs()
        assert bool((err <= bn_stats.SUM_RTOL * scale + (rnd + 2.0 ** -21) * ref.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 416, 416), (2, 1024, 13, 13), (3, 40, 9, 11)])
def test_cuda_bn_leaky_one_kernel_each_way_and_dy_in_the_other_layout(cuda_device, shape):
    """One device kernel each way (by the profiler, where it records the
    card), named ``bn_leaky_fwd_*`` and ``bn_leaky_bwd_*``; a dy in the
    other memory format than x is copied to x's once and gives the same
    bits. Tolerance: none."""
    for dtype in (torch.float32, torch.bfloat16):
        for channels_last in (True, False):
            x, dy, mean, var, gamma, beta = _k7_case(5, shape, dtype, channels_last, cuda_device)
            args = (mean, var, gamma, beta, EPS, SLOPE)
            with torch.no_grad():
                names = _device_kernels(lambda: bn_leaky.bn_leaky(x, *args))
            if names:  # the profiler may show no device activity on some machines
                assert len(names) == 1 and "bn_leaky_fwd_" in names[0], names
            names = _device_kernels(lambda: bn_leaky.bn_leaky_dx(x, dy, *args))
            if names:
                assert len(names) == 1 and "bn_leaky_bwd_" in names[0], names
            want = bn_leaky.bn_leaky_dx(x, dy, *args)
            other = dy.contiguous(memory_format=torch.contiguous_format if channels_last
                                  else torch.channels_last)
            copies = bn_leaky.bn_leaky_dx.dy_copies
            got = bn_leaky.bn_leaky_dx(x, other, *args)
            torch.cuda.synchronize()
            assert bn_leaky.bn_leaky_dx.dy_copies == copies + 1
            assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_bn_leaky_raises_on_what_it_does_not_take(cuda_device):
    x, dy, mean, var, gamma, beta = _k7_case(1, (2, 8, 6, 6), torch.float32, False, cuda_device)
    for args, match in (((x[:, :, ::2], mean, var, gamma, beta), "layout"),
                        ((x.half(), mean, var, gamma, beta), "activation"),
                        ((x, mean.double(), var, gamma, beta), "statistics"),
                        ((x, mean, var, gamma, beta.bfloat16()), "parameters")):
        with pytest.raises(ValueError, match=match):
            bn_leaky.bn_leaky(*args, EPS, SLOPE)
    with pytest.raises(ValueError, match="statistics"):
        bn_leaky.bn_leaky_dx(x, dy, mean[:4], var, gamma, beta, EPS, SLOPE)


@pytest.mark.cuda
def test_cuda_training_tail_k7_cannot_take_raises(cuda_device):
    """``layers.batch_norm``'s route on the card: a dense f32 tail is
    ``fused``, a float64 one (the referee's precision) evaluates the plain
    expression by its reason, any other tail K7 does not take raises (the
    statistics given, so that K5 does not refuse the activation first)."""
    x, _, mean, var, gamma, beta = _k7_case(2, (2, 8, 6, 6), torch.float32, False, cuda_device)
    assert bn_leaky.route(x, mean, var, gamma, beta) == "fused"
    assert bn_leaky.route(x.double(), mean, var, gamma, beta) == "activation torch.float64 4-d"
    params, state = {"gamma": gamma, "beta": beta}, {"mean": mean, "var": var}
    for xi, moments, match in ((x[:, :, ::2], (mean, var), "layout"),
                               (x.half(), (mean, var), "activation"),
                               (x, (mean.double(), var), "statistics")):
        with pytest.raises(ValueError, match=match):
            L.batch_norm(xi, params, state, train=True, moments=moments, leaky=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_train_step_routes_every_bn_tail_through_k7(cuda_device, dtype, monkeypatch):
    """The tiny model's loss and gradients on the card (B=2, 96², Keras-default
    weights): every one of its 11 BN tails through K7 (one launch each way
    a tail), and with ``remat: conv`` the recomputed tails too; against the
    same step with K7's route refused (the plain expression on the card).
    Tolerance: the loss 1e-6 relative (the forward is bit-equal; the convs
    may pick other algorithms); in f32 (IEEE, as the port's fp32 step pins
    it) every gradient leaf within 1e-4 of its
    largest entry of the plain step's, K7 with and without remat the same
    (K7's sums against autograd's, through 13 layers)."""
    import os

    from yolov3_tpu_torch.device import pin_fp32_ieee
    from yolov3_tpu_torch.models import network as tnet
    from yolov3_tpu_torch.models.spec import parse_model_config
    from yolov3_tpu_torch.parallel import train_step as tts
    from yolov3_tpu_torch.tree import tree_leaves

    if dtype == torch.float32:
        pin_fp32_ieee(cuda_device)  # as the port's fp32 train step: no TF32 in the convs
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = parse_model_config(os.path.join(root, "config/models/yolov3_tiny/model.yaml"), 3)
    params, state = (tnet.to_device(t, cuda_device)
                     for t in tnet.init_model(spec, torch.Generator().manual_seed(0)))
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(2, 96, 96, 3).astype(np.float32)).to(cuda_device)
    labels = np.zeros((2, 10, 6), np.float32)
    labels[:, :2] = [[0.2, 0.2, 0.5, 0.6, 1, 1], [0.5, 0.1, 0.9, 0.4, 1, 2]]
    anchors = np.array([[0.1, 0.1], [0.2, 0.2], [0.3, 0.3], [0.4, 0.4], [0.5, 0.5],
                        [0.6, 0.6]], np.float32).reshape(2, 3, 2)

    def step(remat=False):
        grads, _, m = tts.loss_and_grads(
            spec, params, state, images, torch.from_numpy(labels).to(cuda_device), anchors,
            tnet.head_grid_sizes(spec, 96), 2,
            compute_dtype=None if dtype == torch.float32 else dtype, remat=remat)
        return tree_leaves(grads), float(m["total_loss"])

    counts = (bn_leaky.bn_leaky.launches, bn_leaky.bn_leaky_dx.launches)
    tails = bn_leaky.bn_leaky.tails.copy()
    fused, loss = step()
    fused_remat, loss_remat = step("conv")
    torch.cuda.synchronize()
    assert bn_leaky.bn_leaky.tails - tails == {"fused": 33}
    assert (bn_leaky.bn_leaky.launches - counts[0], bn_leaky.bn_leaky_dx.launches - counts[1]) == (
        33, 22)
    monkeypatch.setattr(bn_leaky, "route", lambda *args: "plain")  # the expression on the card
    plain, plain_loss = step()
    assert np.isfinite(loss) and abs(loss - plain_loss) <= 1e-6 * abs(plain_loss)
    assert abs(loss_remat - loss) <= 1e-6 * abs(loss)
    if dtype == torch.float32:
        for got, again, want in zip(fused, fused_remat, plain):
            scale = max(float(want.abs().max()), 1e-30)
            assert float((got - want).abs().max()) <= 1e-4 * scale
            assert float((again - got).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_stem_s2d_step_routes_every_bn_tail_through_k7(cuda_device, dtype, monkeypatch):
    """YOLOv3's train step with the space-to-depth stem (B=2, 96², seeded
    init): all 72 BN tails through K7,
    the stem's four phase groups among them with the tiled vectors, one
    launch each way a tail; against the same step with the plain expression
    on the card. Tolerance: the loss 1e-6 relative (the forward is
    bit-equal; the convs may pick other algorithms); every gradient leaf
    finite."""
    import os

    from yolov3_tpu_torch.device import pin_fp32_ieee
    from yolov3_tpu_torch.models import network as tnet
    from yolov3_tpu_torch.models.spec import parse_model_config
    from yolov3_tpu_torch.ops.s2d import s2d_stem_train
    from yolov3_tpu_torch.parallel import train_step as tts
    from yolov3_tpu_torch.tree import tree_leaves

    if dtype == torch.float32:
        pin_fp32_ieee(cuda_device)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = parse_model_config(os.path.join(root, "config/models/yolov3/model.yaml"), 3)
    params, state = (tnet.to_device(t, cuda_device)
                     for t in tnet.init_model(spec, torch.Generator().manual_seed(0)))
    s2d = s2d_stem_train(spec, 96)
    assert s2d is not spec
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(2, 96, 96, 3).astype(np.float32)).to(cuda_device)
    labels = np.zeros((2, 10, 6), np.float32)
    labels[:, :2] = [[0.2, 0.2, 0.5, 0.6, 1, 1], [0.5, 0.1, 0.9, 0.4, 1, 2]]
    anchors = np.array([[0.02, 0.03], [0.04, 0.07], [0.08, 0.06], [0.07, 0.15], [0.15, 0.11],
                        [0.14, 0.29], [0.28, 0.22], [0.38, 0.48], [0.9, 0.78]],
                       np.float32).reshape(3, 3, 2)

    def step():
        grads, _, m = tts.loss_and_grads(
            s2d, params, state, images, torch.from_numpy(labels).to(cuda_device), anchors,
            tnet.head_grid_sizes(spec, 96), 2,
            compute_dtype=None if dtype == torch.float32 else dtype)
        return tree_leaves(grads), float(m["total_loss"])

    counts = (bn_leaky.bn_leaky.launches, bn_leaky.bn_leaky_dx.launches)
    tails = bn_leaky.bn_leaky.tails.copy()
    grads, loss = step()
    torch.cuda.synchronize()
    assert bn_leaky.bn_leaky.tails - tails == {"fused": 72}
    assert (bn_leaky.bn_leaky.launches - counts[0],
            bn_leaky.bn_leaky_dx.launches - counts[1]) == (72, 72)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    monkeypatch.setattr(bn_leaky, "route", lambda *args: "plain")
    _, plain_loss = step()
    assert np.isfinite(loss) and abs(loss - plain_loss) <= 1e-6 * abs(plain_loss)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,grids,k", [(0, (13, 26, 52), 256), (1, (13, 26), 512)])
def test_cuda_detect_equals_the_unfused_path(cuda_device, seed, grids, k):
    """``ops/detect.detect`` on the card (its suppression one K1 launch)
    against decode ∘ yolo_nms ∘ gather_detections on the card. Tolerance:
    valid masks and classes equal; boxes and scores 1e-6 relative (the two
    paths take exp and sigmoid over tensors of other lengths)."""
    from yolov3_tpu_torch.ops import detect
    from yolov3_tpu_torch.ops.decode import yolo_decode
    from yolov3_tpu_torch.ops.nms import gather_detections, yolo_nms

    rng = np.random.RandomState(seed)
    anchors = rng.uniform(0.02, 0.5, (len(grids), 3, 2)).astype(np.float32)
    heads = [torch.from_numpy(rng.normal(0, 2, (4, g, g, 3, 8)).astype(np.float32))
             .to(cuda_device) for g in grids]
    kw = dict(max_boxes=100, iou_threshold=0.5, score_threshold=0.3, num_candidates=k)
    before = nms_kernel.suppression_sweep.launches
    got = detect.detect(heads, anchors, 3, **kw)
    torch.cuda.synchronize()
    assert nms_kernel.suppression_sweep.launches == before + 1
    want = gather_detections(*yolo_nms(*yolo_decode(heads, anchors, 3), **kw))
    valid = want[3]
    assert torch.equal(got[3], valid) and int(valid.sum()) > 0
    assert torch.equal(got[1][valid], want[1][valid])
    for i in (0, 2):
        assert torch.allclose(got[i][valid], want[i][valid], rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_cuda_matcher_equals_cpu(cuda_device):
    """The evaluator's batched matcher on the card against the CPU, on
    corner cases: exact IoU ties between gts of other classes (argmax takes
    the first), an image with no valid gt (rows of -1), an inf and a NaN box.
    Tolerance: none."""
    from yolov3_tpu_torch.eval.detections_evaluator import evaluate_image_counters

    rng = np.random.RandomState(4)
    b, p, g = 8, 40, 12
    xy = rng.rand(b, g, 2) * 0.7
    gt_boxes = np.concatenate([xy, xy + rng.rand(b, g, 2) * 0.3 + 0.02], -1).astype(np.float32)
    gt_boxes[:, 1] = gt_boxes[:, 0]
    gt_classes = rng.randint(0, 5, (b, g)).astype(np.int32)
    gt_valid = rng.rand(b, g) < 0.8
    gt_valid[2] = False
    pick = rng.randint(0, g, (b, p))
    pred_boxes = (np.take_along_axis(gt_boxes, pick[..., None], 1)
                  + rng.normal(0, 0.03, (b, p, 4))).astype(np.float32)
    pred_boxes[:, 0] = gt_boxes[:, 0]
    pred_boxes[3, 1] = [0.1, 0.1, np.inf, 0.5]
    pred_boxes[3, 2] = [np.nan, 0.2, 0.4, 0.4]
    pred_classes = np.take_along_axis(gt_classes, pick, 1)
    pred_valid = rng.rand(b, p) < 0.9
    args = [torch.from_numpy(a) for a in (pred_boxes, pred_classes, pred_valid, gt_boxes,
                                          gt_classes, gt_valid)]
    want = evaluate_image_counters(*args, 5, 0.5)
    got = evaluate_image_counters(*(a.to(cuda_device) for a in args), 5, 0.5)
    for key, value in want.items():
        assert torch.equal(got[key].cpu(), value), key
    assert int(want["tp"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out", [((2, 256, 256, 3), (416, 416)), ((333, 500, 3), (416, 416)),
                                       ((3, 416, 416, 3), (207, 311))])
def test_cuda_image_ops_equal_cpu(cuda_device, shape, out):
    """``ops/image`` resize and letterbox on the card against the CPU.
    Tolerance: 1e-5."""
    from yolov3_tpu_torch.ops import image

    x = torch.from_numpy(np.random.RandomState(5).rand(*shape).astype(np.float32))
    for fn in (image.resize_bilinear, image.letterbox_resize):
        got, want = fn(x.to(cuda_device), *out).cpu(), fn(x, *out)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("nbatches", [1, 2])
def test_cuda_bn_recalibration_runs_k5(cuda_device, monkeypatch, nbatches):
    """BatchNorm recalibration (tools/bn_recalibrate.py) on the card, YOLOv3-tiny
    at 96 px, seeded weights: one K5 forward launch for each BN layer and
    batch, none backward; the recalibrated statistics bit-equal to K5's
    moments of the activations each BN layer received, through the state
    update of ``layers.batch_norm`` and the tool's algebra (nothing else
    computes them); and K5's moments of those activations, and its plain
    version's, against float64 per channel: mean within ``SUM_RTOL`` of E|x|,
    var within ``3 · SUM_RTOL`` of E[x²] (K5's sums are taken in another order
    than the plain version's, so the two are not bit-equal: the kernel's
    stated tolerance)."""
    import os

    from yolov3_tpu_torch.models import init_model, layers, parse_model_config
    from yolov3_tpu_torch.tools.bn_recalibrate import recalibrate
    from yolov3_tpu_torch.tree import tree_leaves

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = parse_model_config(os.path.join(repo, "config/models/yolov3_tiny/model.yaml"), 3)
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(5)
    batches = [rng.rand(4, 96, 96, 3).astype(np.float32) for _ in range(nbatches)]
    bn_layers = [(sm.name, f"layer{i}") for sm in spec.sub_models
                 for i, layer in enumerate(sm.layers)
                 if layer.kind == "convolutional" and layer["batch_normalize"]]
    seen = []  # (activation, K5's mean, K5's var) of every call, in order

    def recording(x):
        mean, var = bn_stats.bn_moments(x)
        seen.append((x.detach().clone(), mean.clone(), var.clone()))
        return mean, var

    monkeypatch.setattr(layers, "bn_moments", recording)
    fwd, bwd = bn_stats.bn_sums.launches, bn_stats.bn_moments_dx.launches
    got, n = recalibrate(spec, params, state, batches, 0.99, device="cuda")
    assert n == nbatches and len(seen) == len(bn_layers) * nbatches
    assert bn_stats.bn_sums.launches - fwd == len(bn_layers) * nbatches
    assert bn_stats.bn_moments_dx.launches == bwd

    m = 0.99
    for j, (sm, key) in enumerate(bn_layers):
        old = {k: v.to(cuda_device) for k, v in state[sm][key].items()}
        acc = {}
        for b in range(nbatches):
            x, mean, var = seen[b * len(bn_layers) + j]
            for name, stat in (("mean", mean), ("var", var)):
                new = m * old[name] + (1.0 - m) * stat
                batch_stat = (new - m * old[name]) / (1.0 - m)
                acc[name] = batch_stat if name not in acc else acc[name] + batch_stat
            xf = x.double()
            mean64 = xf.mean(dim=(0, 2, 3))
            var64 = (xf * xf).mean(dim=(0, 2, 3)) - mean64 * mean64
            mean_tol = bn_stats.SUM_RTOL * xf.abs().mean(dim=(0, 2, 3))
            var_tol = 3 * bn_stats.SUM_RTOL * (xf * xf).mean(dim=(0, 2, 3))
            for mu, v in ((mean, var), bn_stats.bn_moments_plain(x)):
                assert bool(((mu.double() - mean64).abs() <= mean_tol).all())
                assert bool(((v.double() - var64).abs() <= var_tol).all())
        for name in ("mean", "var"):
            assert torch.equal(got[sm][key][name], (acc[name] / nbatches).cpu()), (sm, key, name)
    assert all(t.device.type == "cpu" for t in tree_leaves(got))


# --- the kernels as torch.library ops (yolov3_torch::…) ---

def _op_cases(device):
    """name → (op, its arguments on the card, the plain version, the wrapper
    on the same arguments, the wrapper whose ``launches`` counts the op):
    K1 at the serving K, K2 over the round sweep's cluster, K3's persistent
    path, K6's wgmma path (3×3 s1), K4 on the (64, 128) tile pair."""
    rng = np.random.RandomState(17)
    mat, valid = (torch.from_numpy(a).to(device) for a in _sweep_case(3, 4, 512))
    boxes, scores = (torch.from_numpy(a).to(device) for a in _boxes_case(4, 3, 2000))
    xq, wq = _int8(rng, (300, 64), device), _int8(rng, (32, 64), device)
    s3, b3, inv = _epilogue(rng, 32, device, 1e-3)
    x6, k6 = _int8(rng, (2, 13, 13, 64), device), _int8(rng, (128, 3, 3, 64), device, 20)
    s6, b6, _ = _epilogue(rng, 128, device, 1e-4)
    k4 = _resblock_args(rng, 2, 13, 13, 128, 64, device)
    return {
        "suppression_sweep": (
            torch.ops.yolov3_torch.suppression_sweep.default, (mat, valid),
            nms_kernel.suppression_sweep_ref, lambda: nms_kernel.suppression_sweep(mat, valid),
            nms_kernel.suppression_sweep),
        "round_sweep": (
            torch.ops.yolov3_torch.round_sweep.default, (boxes, scores, 0.5, 0.1, 100),
            round_sweep.round_sweep_ref,
            lambda: round_sweep.round_sweep(boxes, scores, 0.5, 0.1, 100), round_sweep.round_sweep),
        "conv1x1_int8_requant": (
            torch.ops.yolov3_torch.conv1x1_int8_requant.default,
            (xq, wq, s3, b3, inv, True, torch.int8),
            lambda *a: conv1x1.conv1x1_int8_requant_plain(*a[:5], leaky=a[5], out_dtype=a[6]),
            lambda: conv1x1.conv1x1_int8_requant(xq, wq, s3, b3, inv, leaky=True),
            conv1x1.conv1x1_int8_requant),
        "conv_int8": (
            torch.ops.yolov3_torch.conv_int8.default,
            (x6, k6, s6, b6, None, 1, [1, 1, 1, 1], True, torch.float32),
            lambda *a: conv_int8.conv_int8_plain(*a[:5], stride=a[5], padding=(a[6][:2], a[6][2:]),
                                                 leaky=a[7], out_dtype=a[8]),
            lambda: conv_int8.conv_int8(x6, k6, s6, b6, None, stride=1, padding=((1, 1), (1, 1)),
                                        leaky=True, out_dtype=torch.float32),
            conv_int8.conv_int8),
        "fused_resblock": (
            torch.ops.yolov3_torch.fused_resblock.default, (*k4, 2, 13, 13),
            lambda *a: resblock.fused_resblock_plain(*a[:12], b=a[12], h=a[13], w=a[14]),
            lambda: resblock.fused_resblock(*k4, b=2, h=13, w=13), resblock.fused_resblock),
    }


OP_NAMES = ["suppression_sweep", "round_sweep", "conv1x1_int8_requant", "conv_int8",
            "fused_resblock"]


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.cuda
@pytest.mark.parametrize("name", OP_NAMES)
def test_cuda_op_equals_its_plain_version_and_its_wrapper(cuda_device, name):
    """Each kernel called as ``torch.ops.yolov3_torch.<name>`` on CUDA
    tensors launches once (its wrapper's count), and its outputs are
    bit-equal to the plain version's and to the wrapper's on the same
    inputs. Tolerance: none."""
    op, args, plain, wrapper, counted = _op_cases(cuda_device)[name]
    before = counted.launches
    got = _outputs(op(*args))
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    want = _outputs(plain(*args))
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, _outputs(wrapper())))
    assert all(g.device.type == "cuda" for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", OP_NAMES)
def test_cuda_op_passes_opcheck(cuda_device, name):
    """``torch.library.opcheck`` on the card: the schema, the fake kernel
    against the CUDA kernel, and the op traced with its dimensions dynamic
    (a symbolic batch)."""
    op, args, _, _, _ = _op_cases(cuda_device)[name]
    torch.library.opcheck(op, args)


_FRESH_FP32 = r'''
import json, sys
import numpy as np, torch
from yolov3_tpu_torch.apps.inference_app import build_serving_predictor
from yolov3_tpu_torch.device import fp32_precision
from yolov3_tpu_torch.export import aot
from yolov3_tpu_torch.models import apply_model

mode, path = sys.argv[1:3]
cfg = dict(model_config_file="config/models/yolov3_tiny/model.yaml",
           classes_name_file="datasets/shapes_toy/class.names",
           anchors_file="datasets/shapes_toy/anchors/anchors_tiny.txt",
           input_weights_path="checkpoints/output/yolov3_train_tiny.tf", image_size=416,
           nms_score_threshold=0.1)
images = np.random.RandomState(0).rand(4, 416, 416, 3).astype(np.float32)
row = {"before": fp32_precision()}
cpu = build_serving_predictor(**cfg, device="cpu")[0]
if mode == "predict":
    card, names, _ = build_serving_predictor(**cfg)
    row["after"] = fp32_precision()
    heads = [apply_model(p.module.spec, p.module.tree("params"), p.module.tree("state"),
                         torch.from_numpy(images).to(p.device)) for p in (card, cpu)]
    row["err"] = [float((a.cpu() - b).abs().max()) for a, b in zip(*heads)]
    row["scale"] = [float(b.abs().max()) for b in heads[1]]
    aot.save_detector_artifact(path, aot.export_detector(card.module, 416, ("cuda",)),
                               dict(image_size=416, class_names=list(names), quantize=None))
else:
    loaded, manifest = aot.load_detector_artifact(path)
    row["after"], row["manifest"] = fp32_precision(), manifest["fp32_precision"]
    got, want = loaded(images), cpu(images)
    # every candidate's decoded box and score (before NMS selects any)
    row["err"] = [float((got[i].cpu() - want[i]).abs().max()) for i in (0, 2)]
    row["scale"] = [float(want[i].abs().max()) for i in (0, 2)]
print(json.dumps(row))
'''


@pytest.mark.cuda
def test_cuda_fp32_is_ieee_in_a_fresh_process(cuda_device, tmp_path):
    """fp32 on the card is IEEE fp32 without the caller asking: a process of
    its own that never sets a precision builds the fp32 predictor (trained
    tiny, 416², B=4), and a second one loads its exported ``cuda`` artifact.
    Each starts in PyTorch's default (TF32 in cuDNN's convolutions) and reads
    IEEE afterwards; the manifest says ``ieee``. The card's heads (and the
    loaded program's decoded boxes and scores) are held against the CPU:
    within 1e-3, and within 1e-4 of the largest |value| — TF32 keeps about
    three decimal digits, IEEE fp32 on the card was 1.8e-7 from the CPU on
    YOLOv3-416's heads (PERF.md)."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = str(tmp_path / "tiny_fp32.zip")
    for mode in ("predict", "load"):
        done = subprocess.run([sys.executable, "-c", _FRESH_FP32, mode, path], cwd=repo,
                              capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=repo))
        assert done.returncode == 0, done.stderr[-3000:]
        row = json.loads(done.stdout.strip().splitlines()[-1])
        assert row["before"] == "tf32" and row["after"] == "ieee", row
        for err, scale in zip(row["err"], row["scale"]):
            assert err <= 1e-3 and err <= 1e-4 * scale, row
    assert row["manifest"] == "ieee"


@pytest.mark.cuda
def test_cuda_sync_bn_over_a_group_of_one_is_the_unsynced_path(cuda_device, tmp_path):
    """K5 synced over a process group of this process alone (gloo, CUDA
    tensors) is the unsynced K5 bit for bit, forward and backward, at a
    YOLOv3-416 shape (C=64, 208², B=2, f32, NCHW and channels-last); one
    kernel launch and one all-reduce each way."""
    import torch.distributed as dist

    rng = np.random.RandomState(11)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        for fmt in (torch.contiguous_format, torch.channels_last):
            x0 = torch.from_numpy(rng.randn(2, 64, 208, 208).astype(np.float32)).to(
                cuda_device).contiguous(memory_format=fmt)
            dmean, dvar = (torch.from_numpy(rng.randn(64).astype(np.float32)).to(cuda_device)
                           for _ in range(2))
            outs = []
            for group in (None, dist.group.WORLD):
                x = x0.clone().requires_grad_(True)
                counts = (bn_stats.bn_sums.launches, bn_stats.bn_moments_dx.launches,
                          bn_stats.bn_sums.sync_launches, bn_stats.bn_moments_dx.sync_launches)
                mean, var = bn_stats.bn_moments(x, group=group)
                (mean @ dmean + var @ dvar).backward()
                torch.cuda.synchronize()
                after = (bn_stats.bn_sums.launches, bn_stats.bn_moments_dx.launches,
                         bn_stats.bn_sums.sync_launches, bn_stats.bn_moments_dx.sync_launches)
                assert [a - b for a, b in zip(after, counts)] == [1, 1] + (
                    [0, 0] if group is None else [1, 1])
                outs.append((mean, var, x.grad))
            assert all(torch.equal(a, b) for a, b in zip(*outs))
    finally:
        dist.destroy_process_group()


# K8: (shape, activation) of the main path's fp tails: YOLOv3-416's leaky
# tails 416² to 13² and its 255-channel heads at B=8, YOLOv4-608's Mish
# tails at B=2, and odd shapes (C = 3, sizes that are no multiple of a
# vector) under every activation
K8_CASES = ([((8, c, h, h), "leaky") for c, h in (
    (32, 416), (64, 208), (128, 104), (256, 52), (512, 26), (1024, 13))]
    + [((8, 255, h, h), "linear") for h in (52, 26, 13)]
    + [((2, c, h, h), "mish") for c, h in (
        (32, 608), (64, 304), (128, 152), (256, 76), (512, 38), (1024, 19))]
    + [(shape, act) for shape in ((3, 3, 8, 8), (2, 40, 9, 11), (1, 255, 5, 7), (2, 7, 1, 3))
       for act in bias_act.ACTIVATIONS])


def _k8_case(seed, shape, dtype, channels_last, device, bias_dtype=torch.float32):
    """x (``_activation``, scaled so that Mish and leaky see both signs and
    the bf16 table's edges) and a (C,) bias."""
    x = _activation(seed, shape, dtype, channels_last, device) * 1.5
    rng = np.random.RandomState(seed + 7)
    bias = torch.from_numpy(rng.uniform(-2, 2, shape[1]).astype(np.float32)).to(device,
                                                                               bias_dtype)
    return x, bias


@pytest.mark.cuda
@pytest.mark.parametrize("shape,activation", K8_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
def test_cuda_bias_act_bit_equal_to_the_expression(cuda_device, shape, activation, dtype,
                                                   channels_last):
    """K8, one launch, against the plain expression evaluated by PyTorch on
    the card (``bias_act_plain``: the add, then ``where`` or ATen's Mish).
    Tolerance: none, bit for bit, with an f32 bias and a bf16 one; y in x's
    memory format; two launches give the same bits."""
    for bias_dtype in (torch.float32, torch.bfloat16):
        x, bias = _k8_case(sum(shape), shape, dtype, channels_last, cuda_device, bias_dtype)
        before = bias_act.bias_act.launches
        with torch.no_grad():
            y = bias_act.bias_act(x, bias, activation)
            again = bias_act.bias_act(x, bias, activation)
            want = bias_act.bias_act_plain(x, bias, activation)
        torch.cuda.synchronize()
        assert bias_act.bias_act.launches == before + 2
        assert y.dtype == dtype and y.stride() == x.stride()
        assert torch.equal(_bits(y), _bits(want)) and torch.equal(_bits(y), _bits(again))


@pytest.mark.cuda
@pytest.mark.parametrize("activation", bias_act.ACTIVATIONS)
@pytest.mark.parametrize("channels_last", [True, False])
def test_cuda_bias_act_every_bf16_value(cuda_device, activation, channels_last):
    """Every bf16 number but the NaNs as x (65,280 of them: the whole of the
    Mish table and every value outside it), with a zero bias and with a
    bias, through K8 and through the plain expression on the card.
    Tolerance: none."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    values = bits.view(torch.bfloat16)
    values = values[~torch.isnan(values)]
    x = values[:64 * 1020].reshape(4, 64, 15, 17).to(cuda_device)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    for bias in (torch.zeros(64, device=cuda_device),
                 torch.linspace(-3, 3, 64, device=cuda_device)):
        with torch.no_grad():
            y = bias_act.bias_act(x, bias, activation)
            want = bias_act.bias_act_plain(x, bias, activation)
        assert torch.equal(_bits(y), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("activation", bias_act.ACTIVATIONS)
def test_cuda_bias_act_f32_over_a_wide_range(cuda_device, activation):
    """4M f32 values spread over |x| in [2^-30, 2^30] of both signs, and the
    special values (±0, ±inf, the largest and the smallest), through K8 and
    through the plain expression on the card. Tolerance: none."""
    rng = np.random.RandomState(5)
    mags = np.exp2(rng.uniform(-30, 30, 1 << 22)) * rng.choice([-1.0, 1.0], 1 << 22)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 3.4e38, -3.4e38, 1e-45, -1e-45] * 512)
    flat = np.concatenate([mags, special]).astype(np.float32)
    x = torch.from_numpy(flat).reshape(8, 32, 16, -1).to(cuda_device)
    bias = torch.zeros(32, device=cuda_device)
    with torch.no_grad():
        y = bias_act.bias_act(x, bias, activation)
        want = bias_act.bias_act_plain(x, bias, activation)
    assert torch.equal(_bits(y), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_bias_act_unaligned_and_ragged(cuda_device, dtype):
    """x and y that are no multiple of 16 bytes away from an aligned address
    (the element-at-a-time path), and an element count that is no multiple
    of a vector (the scalar tail). Tolerance: none."""
    n = 2 * 24 * 7 * 9
    flat = np.random.RandomState(3).randn(n + 1).astype(np.float32) * 3
    x = torch.from_numpy(flat).to(cuda_device, dtype)[1:].view(2, 24, 7, 9)
    assert x.data_ptr() % 16 != 0
    bias = torch.linspace(-1, 1, 24, device=cuda_device)
    for activation in bias_act.ACTIVATIONS:
        with torch.no_grad():
            y = bias_act.bias_act(x, bias, activation)
            want = bias_act.bias_act_plain(x, bias, activation)
        assert torch.equal(_bits(y), _bits(want))


@pytest.mark.cuda
def test_cuda_bias_act_one_kernel_named_by_its_activation(cuda_device):
    """One device kernel a call (by the profiler, where it records the
    card), ``bias_act_<activation>_kernel``: ``mish`` in the Mish one's
    symbol, as ``mish_ms.infer`` reads it."""
    x, bias = _k8_case(9, (2, 64, 26, 26), torch.bfloat16, True, cuda_device)
    for activation in bias_act.ACTIVATIONS:
        with torch.no_grad():
            names = _device_kernels(lambda: bias_act.bias_act(x, bias, activation))
        if names:  # the profiler may show no device activity on some machines
            assert len(names) == 1 and f"bias_act_{activation}_kernel" in names[0], names


@pytest.mark.cuda
def test_cuda_bias_act_raises_on_what_it_does_not_take(cuda_device):
    x, bias = _k8_case(1, (2, 8, 6, 6), torch.float32, False, cuda_device)
    for xi, b, match in ((x[:, :, ::2], bias, "layout"), (x.half(), bias, "activation"),
                         (x, bias[:4], "bias"), (x[0], bias, "activation"),
                         (x, bias.cpu(), "bias")):
        with torch.no_grad(), pytest.raises(ValueError, match=match):
            bias_act.bias_act(xi, b, "leaky")


@pytest.mark.cuda
def test_cuda_bias_act_splits_a_batch_past_2_31_elements(cuda_device):
    """A bf16 batch of 765 images of 255 × 105² (2,150,701,875 elements, past
    a launch's 32-bit flat index) in two launches of whole images, the second
    starting at an address no multiple of 16 (elements one a thread there):
    bit-equal to the plain expression on the card."""
    shape = (765, 255, 105, 105)
    x = torch.empty(shape, dtype=torch.bfloat16, device=cuda_device).contiguous(
        memory_format=torch.channels_last)
    x.copy_(torch.linspace(-12.0, 12.0, 8191, dtype=torch.bfloat16, device=cuda_device).repeat(
        x.numel() // 8191 + 1)[:x.numel()].view(765, 105, 105, 255).permute(0, 3, 1, 2))
    bias = torch.linspace(-2.0, 2.0, 255, device=cuda_device)
    before = bias_act.bias_act.launches
    with torch.no_grad():
        y = bias_act.bias_act(x, bias, "leaky")
        want = bias_act.bias_act_plain(x, bias, "leaky")
    torch.cuda.synchronize()
    assert bias_act.bias_act.launches == before + 2
    assert y.stride() == x.stride() and torch.equal(_bits(y), _bits(want))
    del x, y, want
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("model,size,tails", [("yolov3", 416, 75), ("yolov4", 608, 110)])
def test_cuda_serving_forward_routes_every_tail_through_k8(cuda_device, model, size, tails,
                                                           monkeypatch):
    """The folded bf16 forward on the card (B=2, seeded weights, channels-last
    images, under ``inference_mode``): every fp conv's tail through K8, one
    launch each (75 for YOLOv3-416, 110 for YOLOv4-608), and the heads bit for
    bit those of the same forward with the plain expression on the card."""
    import os

    from yolov3_tpu_torch.models import apply_model, fold_batch_norm, init_model
    from yolov3_tpu_torch.models.network import to_device
    from yolov3_tpu_torch.models.spec import parse_model_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = parse_model_config(os.path.join(root, f"config/models/{model}/model.yaml"), 80)
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    folded = to_device(fold_batch_norm(params, state), cuda_device, torch.bfloat16)
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.rand(2, size, size, 3).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    bias_act.bias_act.tails.clear()
    launches = bias_act.bias_act.launches
    with torch.inference_mode():
        heads = apply_model(spec, folded, {}, images)
    assert dict(bias_act.bias_act.tails) == {"fused": tails}
    assert bias_act.bias_act.launches == launches + tails
    monkeypatch.setattr(bias_act, "route", lambda x, bias: "plain on the card")
    with torch.inference_mode():
        plain = apply_model(spec, folded, {}, images)
    assert bias_act.bias_act.launches == launches + tails
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(heads, plain))
