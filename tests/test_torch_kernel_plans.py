"""The launch plans of the port's redesigned kernels, on the CPU: pure
Python that mirrors what the CUDA launch functions do with a shape.

  * K5 (``ops/cuda/bn_stats.py::_plan``): the grid and block sizes cover every
    element of the activation exactly once, in both memory layouts, and are a
    pure function of the shape; the thread loops of ``csrc/bn_stats.cu`` are
    replayed index by index at small shapes.
  * K6 (``ops/cuda/conv_int8.py::plan``): path, tile and grid cover M and N
    of the implicit GEMM, the contraction's split covers every k-tile once,
    and the byte path takes Cin = 3 and every ``Cin % 16 != 0``.

The shapes are the real ones: every BatchNorm input and every non-1×1 conv
of YOLOv3-416 and YOLOv3-tiny, recorded from one forward of the port's
network on the CPU. No tolerance: integers only."""

import functools
import os

import numpy as np
import pytest
import torch

from yolov3_tpu_torch import models
from yolov3_tpu_torch.models import layers
from yolov3_tpu_torch.ops.cuda import bn_stats, conv_int8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ODD_BN_SHAPES = [(32, 5, 7), (3, 8, 8), (40, 9, 11), (1024, 4, 4), (7, 1, 1), (130, 33, 65)]
PLANES_BLOCKS = {(256, 256), (256, 32), (128, 32)}  # (threads, lanes) the kernel is built for


@functools.lru_cache(maxsize=None)
def recorded_shapes(model: str):
    """(BN inputs as (C, H, W), convs as (H, Cin, Cout, k, stride)) of one
    416² training-mode forward of ``config/models/<model>/model.yaml``."""
    spec = models.parse_model_config(os.path.join(ROOT, f"config/models/{model}/model.yaml"), 80)
    params, state = models.init_model(spec, torch.Generator().manual_seed(0))
    bn_inputs, convs = [], []
    real_bn, real_conv = layers.batch_norm, layers.conv2d

    def batch_norm(x, *args, **kw):
        bn_inputs.append(tuple(x.shape[1:]))
        return real_bn(x, *args, **kw)

    def conv2d(x, kernel, stride, *args, **kw):
        convs.append((x.shape[2], kernel.shape[1], kernel.shape[0], kernel.shape[2], stride))
        return real_conv(x, kernel, stride, *args, **kw)

    layers.batch_norm, layers.conv2d = batch_norm, conv2d
    try:
        with torch.no_grad():
            models.apply_model(spec, params, state, torch.zeros(1, 416, 416, 3), train=True)
    finally:
        layers.batch_norm, layers.conv2d = real_bn, real_conv
    return tuple(bn_inputs), tuple(convs)


def test_recorded_shapes_are_the_models():
    bn, convs = recorded_shapes("yolov3")
    assert len(bn) == 72 and len(convs) == 75
    assert sum(k > 1 for _, _, _, k, _ in convs) == 38  # 38 K6 launches a forward
    assert sum(h <= 52 for _, h, _ in bn) == 63
    bn_tiny, convs_tiny = recorded_shapes("yolov3_tiny")
    assert len(bn_tiny) == 11 and len(convs_tiny) == 13


def check_k5_plan(channels_last, b, c, hw):
    p, per_block, threads, lanes, inv_n = bn_stats._plan(channels_last, b, c, hw)
    assert bn_stats._plan(channels_last, b, c, hw) == (p, per_block, threads, lanes, inv_n)
    assert inv_n == float(np.float32(1.0) / np.float32(b * hw))
    reduced = b * hw if channels_last else hw
    # p slices of per_block tile the reduced axis: none empty, none missing
    assert p >= 1 and (p - 1) * per_block < reduced <= p * per_block
    if channels_last:
        assert (threads, lanes) == (256, 32) and per_block % 8 == 0
        assert p * -(-c // 32) <= max(bn_stats._MAX_BLOCKS_CL, -(-c // 32))
    else:
        assert (threads, lanes) in PLANES_BLOCKS
        assert p == 1 or per_block % 8 == 0  # 16-byte loads never straddle a slice
        assert p * c <= max(bn_stats._MAX_BLOCKS, c)
    return p, per_block, threads, lanes


@pytest.mark.parametrize("model", ["yolov3", "yolov3_tiny"])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("b", [1, 2, 16])
def test_k5_plan_covers_every_bn_input(model, channels_last, b):
    for c, h, w in set(recorded_shapes(model)[0]):
        check_k5_plan(channels_last, b, c, h * w)


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("b", [1, 2, 16])
def test_k5_plan_covers_odd_shapes(channels_last, b):
    for c, h, w in ODD_BN_SHAPES:
        check_k5_plan(channels_last, b, c, h * w)


def replay_planes(b, c, hw, p, per_block, threads, lanes, vec):
    """Count how often the planes kernel's loops touch each element."""
    seen = np.zeros((b, c, hw), np.int32)
    for ch in range(c):
        for y in range(p):
            i0, i1 = y * per_block, min((y + 1) * per_block, hw)
            for tid in range(threads):
                group, lane = divmod(tid, lanes)
                for n in range(group, b, threads // lanes):
                    for i in range(i0 + lane * vec, i1, lanes * vec):
                        assert i + vec <= i1  # a vector load stays inside its slice
                        seen[n, ch, i:i + vec] += 1
    return seen


def replay_channels_last(b, c, hw, p, per_block):
    seen = np.zeros((b * hw, c), np.int32)
    for x in range(p):
        r0, r1 = x * per_block, min((x + 1) * per_block, b * hw)
        for y in range(-(-c // 32)):
            for ty in range(8):
                for tx in range(32):
                    if y * 32 + tx < c:
                        seen[r0 + ty:r1:8, y * 32 + tx] += 1
    return seen


@pytest.mark.parametrize("b,c,h,w", [(3, 32, 5, 7), (2, 5, 13, 13), (1, 3, 8, 8), (16, 4, 26, 26),
                                     (2, 2, 104, 104), (5, 33, 9, 11)])
def test_k5_thread_loops_touch_every_element_once(b, c, h, w):
    hw = h * w
    p, per_block, threads, lanes = check_k5_plan(False, b, c, hw)
    for elem_bytes in (4, 2):  # f32 and bf16: 16-byte loads where the launch takes them
        vec = 16 // elem_bytes
        if not (hw % vec == 0 and (p == 1 or per_block % vec == 0)):
            vec = 1
        assert (replay_planes(b, c, hw, p, per_block, threads, lanes, vec) == 1).all()
    p, per_block, _, _ = check_k5_plan(True, b, c, hw)
    assert (replay_channels_last(b, c, hw, p, per_block) == 1).all()


def test_k5_plan_sizes_follow_the_bytes():
    """The small shapes of the main path are one short block a channel (no
    fold at all); the largest keeps its 2,048 blocks."""
    assert bn_stats._plan(False, 16, 1024, 13 * 13)[:4] == (1, 169, 128, 32)
    assert bn_stats._plan(False, 16, 512, 26 * 26)[:4] == (1, 676, 256, 32)
    p, per_block, threads, lanes, _ = bn_stats._plan(False, 16, 32, 416 * 416)
    assert (p * 32, threads, lanes) == (2048, 256, 256) and per_block % 8 == 0
    assert bn_stats._plan(True, 16, 32, 416 * 416)[0] == 1024


def k6_shapes(model):
    """(H, Cin, Cout, k, stride, (pad, pad)) of the model's non-1×1 convs."""
    return sorted({(h, cin, cout, k, s, layers.conv_padding(k, s, 1))
                   for h, cin, cout, k, s in recorded_shapes(model)[1] if k > 1})


S2D_STEM = [(416, 3, 128, 4, 2, ((1, 2), (1, 2))), (208, 128, 64, 2, 1, ((1, 0), (1, 0)))]


def check_k6_plan(b, h, cin, cout, k, stride, pad):
    ho = conv_int8.out_size(h, k, stride, pad[0])
    wo = conv_int8.out_size(h, k, stride, pad[1])
    m, kk = b * ho * wo, k * k * cin
    plan = conv_int8.plan(m, cin, cout, kk)
    assert plan == conv_int8.plan(m, cin, cout, kk)
    (bm, bn), (mt, nt, split) = plan["tile"], plan["grid"]
    assert plan["path"] == ("wgmma" if cin % 16 == 0 else "mma.sync")
    assert bm == 128 and (mt - 1) * bm < m <= mt * bm
    assert (nt - 1) * bn < cout <= nt * bn
    if plan["path"] == "wgmma":
        assert bn == (128 if cout > 64 else 64)
        kt = -(-kk // 128)
        assert split in (1, 2, 4, 8) and (split == 1 or kt >= 2 * split)
        assert split == 1 or mt * nt * split <= 264
        # every block of the split gets its own, non-empty run of k-tiles
        runs = [(kt * z // split, kt * (z + 1) // split) for z in range(split)]
        assert runs[0][0] == 0 and runs[-1][1] == kt
        assert all(a < e for a, e in runs)
        assert all(runs[z][1] == runs[z + 1][0] for z in range(split - 1))
        if split < 8 and kt >= 4 * split:  # it stopped doubling because the card is full
            assert mt * nt * split * 2 > 264
    else:
        assert split == 1 and bn == (128 if cout > 64 else 64 if cout > 32 else 32)
    return plan


@pytest.mark.parametrize("model", ["yolov3", "yolov3_tiny"])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_k6_plan_covers_every_conv(model, b):
    shapes = k6_shapes(model) + S2D_STEM
    paths = {check_k6_plan(b, *shape)["path"] for shape in shapes}
    assert paths == {"wgmma", "mma.sync"}  # the stem's Cin = 3, and all the rest
    for h, cin, cout, k, stride, pad in shapes:
        assert (check_k6_plan(b, h, cin, cout, k, stride, pad)["path"] == "wgmma") == (cin != 3)


@pytest.mark.parametrize("cin", [3, 1, 8, 20, 24, 100, 1000])
def test_k6_plan_sends_unaligned_channels_to_the_byte_path(cin):
    for cout in (16, 40, 130):
        plan = check_k6_plan(2, 13, cin, cout, 3, 1, ((1, 1), (1, 1)))
        assert plan["path"] == "mma.sync" and plan["grid"][2] == 1


def test_k6_plan_splits_the_contraction_for_small_batches():
    """The head's 13² conv (512→1024) at the serving buckets: 16 tiles at
    B=1 become 128 blocks, 48 at B=4 become 192; B=16 fills the card unsplit."""
    head = (13, 512, 1024, 3, 1, ((1, 1), (1, 1)))
    assert check_k6_plan(1, *head)["grid"] == (2, 8, 8)
    assert check_k6_plan(4, *head)["grid"] == (6, 8, 4)
    assert check_k6_plan(16, *head)["grid"] == (22, 8, 1)
