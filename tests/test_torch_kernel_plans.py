"""The launch plans of the port's redesigned kernels, on the CPU: pure
Python that mirrors what the CUDA launch functions do with a shape.

  * K5 (``ops/cuda/bn_stats.py::_plan``): the grid and block sizes cover every
    element of the activation exactly once, in both memory layouts, and are a
    pure function of the shape; the thread loops of ``csrc/bn_stats.cu`` are
    replayed index by index at small shapes.
  * K6 (``ops/cuda/conv_int8.py::plan``): path, tile and grid cover M and N
    of the implicit GEMM, the contraction's split covers every k-tile once,
    and the byte path takes Cin = 3 and every ``Cin % 16 != 0``.
  * K3 (``ops/cuda/conv1x1.py::plan``): tiles cover M and N for the 1×1
    conv's three paths, the persistent grid's walk visits every M-tile once
    and its blocks fit an SM.
  * K1 (``ops/cuda/csrc/nms_sweep.cu``): the pack into bit words and the
    warp's word sweep replayed in numpy, lane by lane, against the plain
    sweep and the JAX package's Pallas kernel in interpret mode; the packed
    matrix fits shared memory at the largest K the wrapper takes.
  * K4 (``ops/cuda/resblock.py::plan``): at every residual block of
    Darknet-53 (YOLOv3-tiny has none) the items cover every output row and
    channel once and the persistent grid walks each once, the band buffer
    fits shared memory and holds every row the expand's shifted loads read,
    and the tap-major k-steps cover the 9·Cm contraction once, A and B alike.
  * K2 (``ops/cuda/csrc/round_sweep.cu``): the cluster's rounds replayed in
    numpy — block-local warp maxima kept from round to round and rescanned
    only where a warp lost a box, the cross-block fold to the lower index —
    against the plain version and the JAX package's Pallas kernel.

The shapes are the real ones: every BatchNorm input and every conv of
YOLOv3-416 and YOLOv3-tiny, recorded from one forward of the port's network
on the CPU. No tolerance: integers and booleans only."""

import functools
import os

import numpy as np
import pytest
import torch

from yolov3_tpu.ops.pallas.nms_kernel import pallas_suppression_sweep
from yolov3_tpu.ops.pallas.round_sweep import pallas_round_sweep
from yolov3_tpu_torch import models
from yolov3_tpu_torch.models import layers
from yolov3_tpu_torch.models import network
from yolov3_tpu_torch.ops.cuda import (bn_stats, conv1x1, conv_int8, nms_kernel, requant,
                                       resblock, round_sweep)

from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

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


# ---------------------------------------------------------------------- K3


def k3_shapes(model):
    """(H, Cin, Cout) of the model's 1×1 stride-1 convs."""
    return sorted({(h, cin, cout) for h, cin, cout, k, s in recorded_shapes(model)[1]
                   if k == 1 and s == 1})


def check_k3_plan(m, cin, cout, out_dtype=torch.int8):
    plan = conv1x1.plan(m, cin, cout, out_dtype)
    assert plan == conv1x1.plan(m, cin, cout, out_dtype)
    (bm, bn), (gx, gy, gz) = plan["tile"], plan["grid"]
    mt = -(-m // bm)
    assert bm == 128 and (mt - 1) * bm < m <= mt * bm
    assert plan["path"] in ("wgmma", "persistent") if cin % 16 == 0 else plan["path"] == "mma.sync"
    if plan["path"] == "persistent":
        assert cin <= 128 and cout <= bn and bn == (128 if cout > 64 else 64 if cout > 32 else 32)
        assert gy == gz == 1 and gx == min(mt, plan["per_sm"] * 132)
        # the grid-stride walk of the M-tiles: each tile once
        walked = sorted(t for x in range(gx) for t in range(x, mt, gx))
        assert walked == list(range(mt))
        # its shared memory: the weight tile, the ring, the output stage; as
        # many blocks an SM as the registers allow (4, 3, 2 by BN) and fit
        smem = (bn * 128 + plan["stages"] * 128 * 128
                + 128 * (bn + 16) * (4 if out_dtype == torch.float32 else 1) + 1024)
        per_sm, most = plan["per_sm"], {32: 4, 64: 3, 128: 2}[bn]
        assert plan["stages"] in (2, 3, 4) and 1 <= per_sm <= most
        assert per_sm * (smem + 2048) <= 233472 if per_sm > 1 else smem <= 232448
        if per_sm < most:  # one more block would not fit, even at two stages
            smem2 = smem - (plan["stages"] - 2) * 128 * 128
            assert (per_sm + 1) * (smem2 + 2048) > 233472
        # the k32 products cover the contraction, the copies stop inside the last one
        kmma = -(-cin // 32)
        assert 1 <= kmma <= 4 and 32 * (kmma - 1) < cin <= 32 * kmma
    else:  # a block a tile, the whole contraction in its k-loop
        assert (gy - 1) * bn < cout <= gy * bn and gx == mt and gz == 1
    if plan["path"] == "wgmma":
        # 128 × 64 where those tiles fill the card's block slots, else 128 × 32
        assert bn == (64 if mt * -(-cout // 64) >= 264 else 32) and (cin > 128 or cout > 128)
    if plan["path"] == "mma.sync":
        assert bn == (128 if cout > 64 else 64 if cout > 32 else 32)
    return plan


@pytest.mark.parametrize("model", ["yolov3", "yolov3_tiny"])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_k3_plan_covers_every_1x1_conv(model, b):
    shapes = k3_shapes(model)
    paths = set()
    for h, cin, cout in shapes:
        for out_dtype in (torch.int8, torch.float32):
            paths.add(check_k3_plan(b * h * h, cin, cout, out_dtype)["path"])
    # every 1×1 conv of both families has Cin % 16 == 0: none on mma.sync
    assert all(cin % 16 == 0 for _, cin, _ in shapes) and "mma.sync" not in paths
    if model == "yolov3":
        assert paths == {"wgmma", "persistent"}
        assert check_k3_plan(b * 208 * 208, 64, 32)["tile"] == (128, 32)


@pytest.mark.parametrize("m,cin,cout", [(1000, 27, 16), (300, 8, 40), (129, 100, 130),
                                        (77, 1000, 3), (5, 3, 255)])
def test_k3_plan_sends_unaligned_channels_to_mma_sync(m, cin, cout):
    assert check_k3_plan(m, cin, cout)["path"] == "mma.sync"


@pytest.mark.parametrize("m,cin,cout,path", [
    (300, 64, 32, "persistent"), (129, 80, 65, "persistent"), (1, 16, 1, "persistent"),
    (257, 48, 255, "wgmma"), (169, 256, 128, "wgmma"), (43227, 256, 128, "wgmma"),
    (5, 144, 200, "wgmma"), (130, 2048, 7, "wgmma"), (692224, 64, 32, "persistent")])
def test_k3_plan_ragged_shapes(m, cin, cout, path):
    for out_dtype in (torch.int8, torch.float32):
        assert check_k3_plan(m, cin, cout, out_dtype)["path"] == path


def test_k3_plan_main_path_shapes():
    """The squeeze convs walk persistently, as many blocks an SM as fit (208²
    64→32: four of two stages with int8 output, three with f32); 52² and 26²
    512→256 take 128 × 64 tiles, 13² 128 × 32 tiles."""
    p = conv1x1.plan(16 * 208 * 208, 64, 32)
    assert (p["grid"], p["stages"], p["per_sm"]) == ((528, 1, 1), 2, 4)
    assert conv1x1.plan(16 * 208 * 208, 64, 32, torch.float32)["per_sm"] == 3
    p = conv1x1.plan(16 * 104 * 104, 128, 64)
    assert (p["grid"], p["stages"], p["per_sm"]) == ((396, 1, 1), 3, 3)
    assert conv1x1.plan(16 * 104 * 104, 128, 64, torch.float32)["per_sm"] == 2
    assert conv1x1.plan(16 * 52 * 52, 256, 128)["grid"] == (338, 2, 1)
    assert conv1x1.plan(16 * 26 * 26, 512, 256)["grid"] == (85, 4, 1)
    assert conv1x1.plan(16 * 169, 1024, 512)["grid"] == (22, 16, 1)


# ---------------------------------------------------------------------- K1

M32 = 0xFFFFFFFF


def k1_pack_replay(mat, valid, rng, r0s, step, r1_of, vec):
    """The kernel's pack of one image, replayed: every (row, word) that
    ``pack_rows`` writes, in its cursor order (warps starting at ``r0s``,
    ``step`` rows apart, stopping at ``r1_of(r0)``; a warp step makes 16 words
    from 16-byte loads or 4 from byte loads, four steps loaded before any is
    used), over a matrix of random words that stand for what the kernel never
    writes. Returns the words, the written mask, the valid words."""
    k = mat.shape[0]
    nw = -(-k // 32)
    padded = np.zeros((k, 32 * nw), bool)
    padded[:, :k] = mat & (np.arange(k)[None, :] > np.arange(k)[:, None])
    truth = np.packbits(padded, axis=1, bitorder="little").view("<u4").astype(np.int64)
    vpad = np.zeros(32 * nw, bool)
    vpad[:k] = valid
    vwords = [int(v) for v in np.packbits(vpad, bitorder="little").view("<u4")]
    words = rng.randint(0, 2 ** 32, size=(k, nw), dtype=np.int64)
    written = np.zeros((k, nw), np.int32)
    span = 16 if vec else 4
    for r0 in r0s:
        r1 = r1_of(r0)

        def next_row(i, r1=r1):
            i += step
            while i < r1 and not valid[i]:
                i += step
            return i

        i = next_row(r0 - step)
        w0 = i >> 5
        while i < r1:
            batch = []
            for _ in range(4):
                batch.append((i, w0))
                if i < r1:
                    w0 += span
                    if w0 >= nw:
                        i = next_row(i)
                        w0 = i >> 5
            for row, w_first in batch:
                if row >= r1:
                    break
                for w in range(w_first, min(w_first + span, nw)):
                    words[row, w] = truth[row, w]
                    written[row, w] += 1
    return words, written, vwords


def k1_sweep_replay(words, written, vwords, k):
    """The warp's sweep, lane by lane: lane l holds dead words l, l + 32, ...
    Asserts that every packed word it uses was written by the pack."""
    nw = -(-k // 32)
    wpl = -(-nw // 32)
    dead = [[(~vwords[lane + 32 * r]) & M32 if lane + 32 * r < nw else M32
             for r in range(wpl)] for lane in range(32)]
    for r in range(wpl):
        for wl in range(32):
            w = 32 * r + wl
            if w >= nw:
                break
            d = [int(words[32 * w + lane, w]) if 32 * w + lane < k else 0 for lane in range(32)]
            dw = dead[wl][r]
            todo = sum(1 << lane for lane in range(32) if d[lane]) & ~dw
            while todo:  # the lowest live row that suppresses something here
                b = (todo & -todo).bit_length() - 1
                todo &= todo - 1
                assert written[32 * w + b, w] == 1  # a live candidate: its row was packed
                dw |= d[b]
                todo &= ~dw
            dead[wl][r] = dw
            kept = ~dw & M32
            while kept:
                b = (kept & -kept).bit_length() - 1
                kept &= kept - 1
                for lane in range(32):
                    for r2 in range(wpl):
                        w2 = lane + 32 * r2
                        if w < w2 < nw:
                            assert written[32 * w + b, w2] == 1
                            dead[lane][r2] |= int(words[32 * w + b, w2])
    keep = np.zeros(k, bool)
    for w in range(nw):
        dw = dead[w % 32][w // 32]
        for lane in range(32):
            if 32 * w + lane < k:
                keep[32 * w + lane] = not (dw >> lane) & 1
    return keep


def k1_case(kind, k, seed):
    rng = np.random.RandomState(seed)
    if kind == "random":
        iou = rng.rand(k, k)
        mat, valid = (iou + iou.T) / 2 > 0.8, rng.rand(k) < 0.6
    elif kind == "chain":  # each box suppresses the next: every other one kept
        mat, valid = np.eye(k, k, 1, dtype=bool), np.ones(k, bool)
    elif kind == "all_valid":
        mat, valid = rng.rand(k, k) > 0.97, np.ones(k, bool)
    elif kind == "none_valid":
        mat, valid = rng.rand(k, k) > 0.5, np.zeros(k, bool)
    else:  # dense: the first valid box suppresses all later ones
        mat, valid = np.ones((k, k), bool), rng.rand(k) < 0.5
    return mat, valid


def k1_replay(mat, valid, seed):
    """The kernel's one launch, both packers: 32 warps striding over all
    rows, with 16-byte and with byte packs."""
    k = mat.shape[0]
    nw = -(-k // 32)
    keeps = []
    for vec in ([True, False] if k % 16 == 0 else [False]):
        words, written, vwords = k1_pack_replay(mat, valid, np.random.RandomState(seed),
                                                range(32), 32, lambda r0: k, vec)
        # exactly the valid rows' words from their own on were written, once each
        own = np.arange(nw)[None, :] >= (np.arange(k) // 32)[:, None]
        assert (written == (own & valid[:, None])).all()
        keeps.append(k1_sweep_replay(words, written, vwords, k))
    return keeps


@pytest.mark.parametrize("k", [1, 31, 32, 33, 100, 512])
def test_k1_word_sweep_replay_equals_plain_and_pallas(k):
    """Random masks at each K: the replayed kernel equals the plain sweep
    and the Pallas TPU kernel in interpret mode. Tolerance: none."""
    mat, valid = k1_case("random", k, k)
    want = nms_kernel.suppression_sweep_ref(torch.from_numpy(mat)[None],
                                            torch.from_numpy(valid)[None])[0].numpy()
    pallas = np.asarray(pallas_suppression_sweep(mat[None].astype(np.float32),
                                                 valid[None].astype(np.float32),
                                                 interpret=True))[0] > 0.5
    np.testing.assert_array_equal(pallas, want)
    for keep in k1_replay(mat, valid, k):
        np.testing.assert_array_equal(keep, want)


@pytest.mark.parametrize("kind", ["chain", "all_valid", "none_valid", "dense"])
@pytest.mark.parametrize("k", [33, 100])
def test_k1_word_sweep_replay_edge_cases(kind, k):
    """A suppression chain, all valid, none valid, a dense mask. Tolerance: none."""
    mat, valid = k1_case(kind, k, k + 1)
    want = nms_kernel.suppression_sweep_ref(torch.from_numpy(mat)[None],
                                            torch.from_numpy(valid)[None])[0].numpy()
    if kind == "chain":
        np.testing.assert_array_equal(want, np.arange(k) % 2 == 0)
    elif kind == "none_valid":
        assert not want.any()
    elif kind == "dense":
        assert want.sum() == 1 and want[np.argmax(valid)]
    pallas = np.asarray(pallas_suppression_sweep(mat[None].astype(np.float32),
                                                 valid[None].astype(np.float32),
                                                 interpret=True))[0] > 0.5
    np.testing.assert_array_equal(pallas, want)
    for keep in k1_replay(mat, valid, k):
        np.testing.assert_array_equal(keep, want)


def test_k1_plan_places_the_packed_matrix():
    """One launch takes every K the wrapper takes: at ``MAX_SWEEP_K`` the
    packed matrix (valid words + K rows of an odd pitch) fits the 227 KB of
    shared memory a block may have, and a lane holds at most two words of a
    row (the kernel is built for one and two); the matrix branch of
    ``yolo_nms`` stays below it."""
    from yolov3_tpu_torch.ops import nms

    k = nms_kernel.MAX_SWEEP_K
    nw = -(-k // 32)
    assert 4 * (-(-nw // 4) * 4 + k * (nw | 1)) <= 232448
    assert -(-nw // 32) <= 2
    assert nms._MATRIX_SWEEP_MAX_K <= k


# ---------------------------------------------------------------------- K4

@functools.lru_cache(maxsize=None)
def k4_blocks(model: str):
    """(H, C, Cm) of every residual block of ``model``'s backbone at 416²,
    from ``resblock.residual_blocks`` and the recorded conv shapes."""
    spec = models.parse_model_config(os.path.join(ROOT, f"config/models/{model}/model.yaml"), 80)
    _, convs = recorded_shapes(model)
    sm = spec.sub_models[0]
    ordinal = {i: n for n, i in enumerate(i for i, layer in enumerate(sm.layers)
                                          if layer.kind == "convolutional")}
    blocks = []
    for starts in resblock.residual_blocks(sm):
        for i in starts:
            h, c, cm, k, stride = convs[ordinal[i]]
            h2, cm2, c2, k2, stride2 = convs[ordinal[i + 1]]
            assert (k, stride, k2, stride2, h2, cm2, c2) == (1, 1, 3, 1, h, cm, c)
            blocks.append((h, c, cm))
    return tuple(blocks)


def test_k4_blocks_are_darknet53s():
    blocks = k4_blocks("yolov3")
    assert len(blocks) == 23
    assert sorted(set(blocks)) == [(13, 1024, 512), (26, 512, 256), (52, 256, 128),
                                   (104, 128, 64), (208, 64, 32)]
    assert k4_blocks("yolov3_tiny") == ()


def check_k4_plan(b, h, w, c, cm):
    pl = resblock.plan(b, h, w, c, cm)
    rows, cols, bn1, bn2 = pl["band_rows"], pl["slice_cols"], pl["bn1"], pl["bn2"]
    assert pl == resblock.plan(b, h, w, c, cm)
    assert pl["smem"] == resblock.smem_bytes(w, cm, rows, bn1, bn2) <= 232448
    assert bn2 == (128 if c > 64 else 64 if c > 32 else 32)
    assert bn1 in ((128, 64) if cm >= 128 else (64,) if cm > 32 else (32,))
    assert (bn1, bn2) in resblock.TILES == ((32, 64), (64, 128), (128, 128))
    assert resblock.supports(c, cm)
    assert pl["slices"] * cols == c and (cols == c or cols % bn2 == 0)
    assert pl["bands"] == -(-h // rows) and pl["items"] == b * pl["bands"] * pl["slices"]
    assert pl["grid"] == min(pl["items"], 132)
    # the persistent walk visits every item once
    walked = sorted(it for blk in range(pl["grid"]) for it in range(blk, pl["items"], pl["grid"]))
    assert walked == list(range(pl["items"]))
    # every row of the halo image, zero rows included, is written once a slice
    wp = w + 2
    written = np.zeros(h + 2, np.int32)
    for band in range(pl["bands"]):
        r0 = 1 + band * rows
        rb = min(rows, h + 1 - r0)
        assert rb >= 1
        written[r0:r0 + rb] += 1
        written[0] += band == 0
        written[h + 1] += band == pl["bands"] - 1
        # the expand's shifted loads: every pixel of every 128-row tile (those
        # past the band read pixel 0's rows) stays inside the buffer of
        # (rows + 2)·wp + 2 rows; an interior pixel reads only rows 1 … m1,
        # which the squeeze wrote
        m1, m2 = (rb + 2) * wp, rb * wp
        pix = np.arange(-(-m2 // 128) * 128)
        a_row = 1 + wp + np.where(pix < m2, pix, 0)
        off = np.array([(t // 3 - 1) * wp + (t % 3 - 1) for t in range(9)])
        read = a_row[:, None] + off[None, :]
        assert read.min() >= 0 and read.max() < (rows + 2) * wp + 2
        col = pix % wp
        interior = (pix < m2) & (col >= 1) & (col <= w)
        assert read[interior].min() >= 1 and read[interior].max() <= m1
    assert (written == 1).all()
    return pl


@pytest.mark.parametrize("model", ["yolov3", "yolov3_tiny"])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_k4_plan_covers_every_residual_block(model, b):
    for h, c, cm in set(k4_blocks(model)):
        check_k4_plan(b, h, h, c, cm)


@pytest.mark.parametrize("b,h,w,c,cm", [(2, 13, 13, 128, 64), (1, 7, 9, 256, 128),
                                        (3, 5, 6, 64, 32), (2, 30, 17, 96, 48),
                                        (2, 9, 11, 160, 80), (1, 6, 50, 512, 256)])
def test_k4_plan_odd_shapes(b, h, w, c, cm):
    check_k4_plan(b, h, w, c, cm)


@pytest.mark.parametrize("c,cm", [(32, 16), (64, 64), (64, 128), (32, 128), (32, 64), (128, 32),
                                  (96, 40), (100, 48)])
def test_k4_plan_raises_outside_its_tiles(c, cm):
    """A block whose tile widths are no pair the kernel is built for (C ≤ 32,
    C = 64 with Cm > 32, C > 64 with Cm ≤ 32) or whose C, Cm are not whole
    16-byte chunks is not taken: ``supports`` says no, and ``plan`` raises
    where the widths are the reason."""
    assert not resblock.supports(c, cm)
    if c % 32 == 0 and cm % 16 == 0:
        with pytest.raises(ValueError, match="no tile pair"):
            resblock.plan(2, 13, 13, c, cm)


@pytest.mark.parametrize("cm", [16, 32, 48, 64, 128, 256, 512])
def test_k4_expand_steps_cover_the_tap_major_contraction_once(cm):
    """A k-step is 128 contraction bytes of the 9·Cm tap-major contraction,
    at most four k32 products (fewer in the last step); the A fragments'
    16-byte halves and the weight loader's 16-byte chunks name the same
    (tap, channel) pairs, each once, and a chunk never straddles two taps."""
    kall = 9 * cm
    steps = -(-kall // 128)
    a_chunks, b_chunks = [], []
    for s in range(steps):
        kmma = min(4, -(-(kall - s * 128) // 32))
        for kk in range(kmma):
            for khalf in (0, 16):
                q = s * 128 + kk * 32 + khalf
                if q < kall:
                    a_chunks.append((q // cm, q % cm))
        for chunk in range(8):
            q = s * 128 + chunk * 16
            if q < kall:
                b_chunks.append((q // cm, q % cm))
                assert (q + 15) // cm == q // cm
    want = [(tap, k) for tap in range(9) for k in range(0, cm, 16)]
    assert sorted(a_chunks) == sorted(b_chunks) == want


def _requant_int_replay(y, inv):
    """``requant.cuh::requant_int`` in numpy float32: clamp y·inv to
    [-128, 128] (fmax/fmin: NaN gives the other operand), add 1.5·2^23,
    read the integer off the low bits, clip to ±127."""
    f = np.float32
    t = np.fmin(np.fmax(y * inv, f(-128)), f(128))
    r = (t + f(12582912.0)).view(np.int32).astype(np.int64) - 0x4B400000
    return np.clip(r, -127, 127)


def test_k0_integer_requant_is_bit_identical():
    """K4's conversion-free requant equals ``requant_clip`` for every kind of
    f32 input: exact halves (ties to even), ±127.5 and ±128.5 at the clip,
    -0, huge values, ±inf, NaN (as the device's fmaxf treats it) and a
    million random values over 80 orders of magnitude; and the magic-number
    f32 of a small integer is exact. Tolerance: none."""
    rng = np.random.RandomState(0)
    f = np.float32
    special = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.5, -127.5, 128.5, -128.5, 127.49998,
                        -0.0, 0.0, 1e-40, 3e38, -3e38, np.inf, -np.inf, np.nan], f)
    y = np.concatenate([special, (rng.randn(10 ** 6) * 10.0 ** rng.uniform(-40, 40, 10 ** 6))
                        .astype(f), (rng.randint(-600, 600, 10 ** 5) / 2).astype(f)])
    for inv in (f(1.0), f(1 / 0.0529), f(0.37), f(3e5)):
        with np.errstate(over="ignore", invalid="ignore"):
            want = np.fmin(np.fmax(np.rint(y * inv), f(-127)), f(127))
            got = _requant_int_replay(y, inv)
        np.testing.assert_array_equal(got, want.astype(np.int64))
        finite = np.isfinite(y * inv)
        plain = requant.requant_clip(torch.from_numpy(y[finite]), torch.tensor(inv)).numpy()
        np.testing.assert_array_equal(got[finite], plain.astype(np.int64))
    v = np.concatenate([np.arange(-300, 300), rng.randint(-2 ** 22, 2 ** 22 + 1, 10 ** 5)])
    magic = ((v + 0x4B400000).astype(np.int32).view(f) - f(12582912.0))
    np.testing.assert_array_equal(magic, v.astype(f))


def test_k4_plan_main_path_shapes():
    """The plans at 416², B = 16, as the kernel's note and PERF.md give them."""
    assert [(p["band_rows"], p["slices"], p["bn1"], p["bn2"], p["items"]) for p in (
        resblock.plan(16, hw, hw, c, c // 2) for hw, c in (
            (208, 64), (104, 128), (52, 256), (26, 512), (13, 1024)))] == [
        (9, 1, 32, 64, 384), (7, 1, 64, 128, 240), (7, 1, 128, 128, 128),
        (4, 1, 128, 128, 112), (7, 4, 128, 128, 128)]


def test_k4_routing_finds_every_darknet53_stage():
    """``network._fusable_stages`` on Darknet-53 with chain-mode quantized
    entries: all five residual stages, none on YOLOv3-tiny; a stage with an
    fp shortcut or a shape outside the kernel's tiles stays unfused."""
    for model, want in (("yolov3", [1, 2, 8, 8, 4]), ("yolov3_tiny", [])):
        spec = models.parse_model_config(
            os.path.join(ROOT, f"config/models/{model}/model.yaml"), 80)
        sm = spec.sub_models[0]

        def entry(i, layer):
            if layer.kind != "convolutional":
                return {"out_scale": 1}
            # (Cout, 1, 1, Cin) with Cin = the next layer's Cout: the squeeze's
            # true shape in a Darknet block, which is all the routing reads
            nxt = sm.layers[i + 1] if i + 1 < len(sm.layers) else layer
            return {"kernel_q": torch.empty((layer["filters"], 1, 1, nxt.get("filters", 1)),
                                            dtype=torch.int8), "out_scale": 1}

        params = {f"layer{i}": entry(i, layer) for i, layer in enumerate(sm.layers)}
        stages = network._fusable_stages(sm, params)
        assert [len(st) for st in stages.values()] == want
        assert all(first == st[0] for first, st in stages.items())
        if stages:
            first = next(iter(stages))
            assert params[f"layer{first}"]["kernel_q"].shape == (32, 1, 1, 64)
            params[f"layer{first}"]["kernel_q"] = torch.empty((32, 1, 1, 32), dtype=torch.int8)
            assert first not in network._fusable_stages(sm, params)
            params[f"layer{first}"] = entry(first, sm.layers[first])
            assert first in network._fusable_stages(sm, params)
            del params[f"layer{first + 2}"]["out_scale"]   # an fp shortcut
            assert first not in network._fusable_stages(sm, params)


# ---------------------------------------------------------------------- K2

NONE = 0x7FFFFFFF


def _best(v, i):
    """(score, index) of the best entry under (score desc, index asc);
    (-inf, NONE) when none is live."""
    live = np.isfinite(v) | (v == np.inf)
    if not live.any():
        return -np.inf, NONE
    top = v[live].max()
    return float(top), int(i[live][v[live] == top].min())


def _iou_f32(a, boxes):
    """The kernel's IoU in float32, one rounding an operation, its order."""
    f = np.float32
    iw = np.maximum(np.minimum(a[2], boxes[:, 2]) - np.maximum(a[0], boxes[:, 0]), f(0))
    ih = np.maximum(np.minimum(a[3], boxes[:, 3]) - np.maximum(a[1], boxes[:, 1]), f(0))
    inter = iw * ih
    area_q = (np.maximum(boxes[:, 2] - boxes[:, 0], f(0))
              * np.maximum(boxes[:, 3] - boxes[:, 1], f(0)))
    area_a = np.maximum(a[2] - a[0], f(0)) * np.maximum(a[3] - a[1], f(0))
    uni = (area_a + area_q) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(uni > 0, inter / np.where(uni > 0, uni, f(1)), f(0)).astype(np.float32)


def k2_cluster_replay(boxes, scores, iou_thr, score_thr, max_boxes, pl):
    """The kernel's rounds for each image: ``pl["cluster"]`` blocks of
    ``pl["share"]`` boxes and ``pl["threads"]`` threads; block k owns boxes
    [k·share, k·share + share), thread t of it the boxes t, t + T, …, warp w
    the boxes of its 32 threads. Each warp's best is cached and recomputed
    only in a round where the warp lost a box (asserted equal to a full
    rescan every round); a block's winner is the best of its warps', the
    cluster's the best of the blocks'. Returns (sel, nv)."""
    b, n = scores.shape
    cs, share, threads = pl["cluster"], pl["share"], pl["threads"]
    idx = np.arange(n)
    rank, local = idx // share, idx % share
    warp = rank * 32 + (local % threads) // 32      # a global id of the owning warp
    sel = np.zeros((b, max_boxes), np.int32)
    nv = np.zeros(b, np.int32)
    thr = np.float32(iou_thr)
    for img in range(b):
        live = np.where(scores[img] > np.float32(score_thr), scores[img],
                        np.float32(-np.inf)).astype(np.float32)
        cache = {w: _best(live[warp == w], idx[warp == w]) for w in np.unique(warp)}
        count = 0
        for r in range(max_boxes):
            assert cache == {w: _best(live[warp == w], idx[warp == w]) for w in cache}
            slots = []
            for k in range(cs):
                ws = [cache[w] for w in cache if w // 32 == k]
                slots.append(_best(np.array([v for v, _ in ws], np.float32),
                                   np.array([i for _, i in ws])) if ws else (-np.inf, NONE))
            v, j = _best(np.array([v for v, _ in slots], np.float32),
                         np.array([i for _, i in slots]))
            if v == -np.inf:
                break
            assert slots[j // share] == (v, j)      # the owner block publishes the box
            sel[img, r] = j
            count += 1
            kill = np.isfinite(live) & ((_iou_f32(boxes[img, j], boxes[img]) > thr)
                                        | (idx == j))
            live[kill] = -np.inf
            for w in np.unique(warp[kill]):
                cache[w] = _best(live[warp == w], idx[warp == w])
        nv[img] = count
    return sel, nv


def k2_case(seed, b, n, tie_levels=40):
    """Boxes as the card tests make them (exact duplicates), scores on a
    coarse lattice (many exact ties), some boxes planted as copies of a box
    with its score, so ties cross warp and block borders."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2) * 0.8
    wh = rng.rand(b, n, 2) * 0.3 + 0.02
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = (np.round(rng.rand(b, n) * tie_levels) / tie_levels).astype(np.float32)
    for src, dst in ((n // 16, n // 8), (1, n - 1), (n // 3, n // 2)):
        boxes[:, dst] = boxes[:, src]
        scores[:, dst] = scores[:, src]
    return boxes, scores


@pytest.mark.parametrize("b,n,score_t,max_boxes", [
    (1, 300, 0.0, 100), (4, 700, 0.3, 100), (16, 500, 0.004, 100), (64, 333, 0.5, 60),
    (2, 40, 0.9, 100), (3, 129, 1.0, 20)])
def test_k2_cluster_replay_equals_plain(b, n, score_t, max_boxes):
    """The replayed cluster rounds at the plan's shape for B = 1, 4, 16, 64
    (clusters of 16, 16, 8, 2) against the plain version: identical indices
    and counts. The last three cases run out of live boxes before their
    last round (all-dead rounds), the last has none live at all. Tolerance:
    none."""
    boxes, scores = k2_case(n + b, b, n)
    pl = round_sweep.plan(b, n)
    assert pl["cluster"] == {1: 16, 4: 16, 16: 8, 64: 2, 2: 16, 3: 16}[b]
    assert pl["cluster"] * pl["share"] >= n and pl["threads"] % 32 == 0
    sel, nv = k2_cluster_replay(boxes, scores, 0.5, score_t, max_boxes, pl)
    want_sel, want_nv = round_sweep.round_sweep_ref(torch.from_numpy(boxes),
                                                    torch.from_numpy(scores), 0.5, score_t,
                                                    max_boxes)
    np.testing.assert_array_equal(sel, want_sel.numpy())
    np.testing.assert_array_equal(nv, want_nv.numpy())
    if score_t >= 0.9:
        assert (nv < max_boxes).all()


def test_k2_cluster_replay_equals_pallas():
    """One case against the JAX package's Pallas kernel in interpret mode."""
    boxes, scores = k2_case(7, 2, 257)
    sel, nv = k2_cluster_replay(boxes, scores, 0.5, 0.2, 30, round_sweep.plan(2, 257))
    want_sel, want_nv = pallas_round_sweep(boxes, scores, 0.5, 0.2, max_boxes=30,
                                           interpret=True)
    np.testing.assert_array_equal(sel, np.asarray(want_sel))
    np.testing.assert_array_equal(nv, np.asarray(want_nv))


def test_k2_plan_fills_the_card_and_bounds_n():
    assert [round_sweep.plan(b, 10647)["cluster"] for b in (1, 2, 4, 8, 16, 32, 64, 128)] == [
        16, 16, 16, 16, 8, 4, 2, 2]   # B = 128: 10,647 boxes need two blocks' memory
    p = round_sweep.plan(16, 10647)
    assert (p["share"], p["threads"], p["grid"], p["smem"]) == (1331, 448, 128, 1331 * 24)
    assert round_sweep.plan(16, 22743)["threads"] == 512
    assert round_sweep.plan(1, 10647)["threads"] == 224
    # a block's boxes fit its shared memory; above what 8 blocks hold the
    # cluster grows to 16 whatever B is
    assert round_sweep.plan(64, 22743)["cluster"] == 4
    assert round_sweep.plan(128, 100000)["cluster"] == 16
    for b, n in ((1, 1), (16, 10647), (128, round_sweep.MAX_N)):
        assert round_sweep.plan(b, n)["smem"] <= 232448 - 1024
    with pytest.raises(ValueError):
        round_sweep.plan(1, round_sweep.MAX_N + 1)
