"""K4 — the fused int8 residual block: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``yolov3_tpu/ops/pallas/resblock.py``
(``fused_resblock``), with its contract and its flat zero-halo layout:
activations travel between fused blocks as a matrix ``(B·(H+2)·(W+2), C)``
int8 whose rows are the pixels of the zero-padded image, so a stage of
blocks pays one layout change in (``to_halo``) and one out (``from_halo``).

    q1  = requant(leaky(acc1·scale1 + bias1), inv_s1)      1×1 squeeze C→Cm
    q2  = requant(leaky(acc2·scale2 + bias2), inv_s2)      3×3 expand Cm→C
    out = requant(x·s_x + q2·s2, inv_out)                  shortcut add

bit-compatible with the unfused chain ``conv2d_int8`` (K3) → ``conv2d_int8``
(K6) → ``add_requant``. The weights come packed as the port keeps them, one
row per output channel: w1 (Cm, C), w2 (9, C, Cm) tap-major (tap = dy·3+dx);
the JAX kernel takes the transposes. ``block_args`` builds a block's
arguments from chain-mode quantized params; those that depend on the params
alone (``block_constants``) the ``int8_chain`` predictor computes once when
it is built (``models/network.py::pack_fused_stages``). The JAX package wires
its kernel into no predictor; the port's ``int8_chain`` tier runs every
residual stage whose shape the kernel takes (``supports``) through
``fused_stage`` (``models/network.py``). The kernel is reached only through
the ``yolov3_torch::fused_resblock`` op (CPU kernel: the plain version; see
``nms_kernel.py``), which makes its operands contiguous.

A band of the spatial split (``parallel/spatial.py``) is a (rows × W) image
whose top or bottom halo row may hold a neighbouring band's pixels and not
zero padding. ``halo_top`` / ``halo_bottom`` say so: the squeeze output q1
of that row is then computed from the row (the 3×3 expand of the band's edge
row reads it), where it is zero at an image edge. The output's halo rows
stay zero either way; ``fused_stage_bands`` refreshes them from the
neighbours before the next block. Both flags false is the image contract,
bit for bit.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .requant import leaky, requant_clip

_BM, _BK = 128, 128          # rows of a block tile, contraction bytes of a k-step
_SQUEEZE_SLOTS, _EXPAND_SLOTS = 4, 6   # ring slots: k-steps in flight ahead + 2
_SMS = 132                   # H100 SXM: the persistent grid's blocks (int8_wgmma.cuh: kSms)
_MAX_SMEM = 232448           # bytes of shared memory a block may use on sm_90
_TILE_OVERHEAD = 8           # a tile's epilogue and drained products, in 128×32×128 k-steps
# (bn1, bn2) tile widths the kernel is built for, those of Darknet-53's blocks:
# the squeeze's over Cm and the expand's over C at C = 64, 128 and ≥ 256
TILES = ((32, 64), (64, 128), (128, 128))


def _squeeze_tiles(c: int, cm: int):
    """The squeeze tile widths ``plan`` may pick for (C, Cm): bn2 follows C,
    bn1 Cm (32 for Cm ≤ 32, 64 below 128, else 128 or 64), kept where the
    pair is in ``TILES``."""
    bn2 = 128 if c > 64 else 64 if c > 32 else 32
    bn1s = (128, 64) if cm >= 128 else (64,) if cm > 32 else (32,)
    return bn2, tuple(bn1 for bn1 in bn1s if (bn1, bn2) in TILES)


def supports(c: int, cm: int) -> bool:
    """Whether the kernel takes a block of C channels squeezed to Cm:
    C % 32 == 0, Cm % 16 == 0 and a pair of tile widths it is built for."""
    return c % 32 == 0 and cm % 16 == 0 and bool(_squeeze_tiles(c, cm)[1])


def smem_bytes(w: int, cm: int, band_rows: int, bn1: int, bn2: int) -> int:
    """Shared memory of a launch (csrc/resblock_int8.cu: ``launch``): the
    ring (the squeeze's and the expand's slots
    take turns in it) with 1 KB to align it, the shortcut's output stage, and
    the q1 band buffer of (R + 2)·(W + 2) + 2 rows at a pitch of
    round_up(Cm, 32) + 16 bytes."""
    ring = max(_SQUEEZE_SLOTS * (_BM + bn1) * _BK, _EXPAND_SLOTS * bn2 * _BK) + 1024
    ldq = -(-cm // 32) * 32 + 16
    return ring + _BM * (bn2 + 16) + ((band_rows + 2) * (w + 2) + 2) * ldq


def halo_mask(h: int, w: int, halo_top: bool = False, halo_bottom: bool = False) -> np.ndarray:
    """(Hp·Wp,) int8 mask: 1 on interior pixels, 0 on the halo ring; 1 also
    on the interior columns of a halo row that holds a neighbour's pixels
    (``halo_top`` / ``halo_bottom``)."""
    m = np.zeros((h + 2, w + 2), np.int8)
    m[1 - int(halo_top):h + 1 + int(halo_bottom), 1:w + 1] = 1
    return m.reshape(-1)


def to_halo(x):
    """(B, H, W, C) → flat zero-halo matrix (B·(H+2)·(W+2), C)."""
    b, h, w, c = x.shape
    return F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(b * (h + 2) * (w + 2), c)


def from_halo(xp, b: int, h: int, w: int):
    """Inverse of ``to_halo``: the interior as (B, H, W, C)."""
    return xp.reshape(b, h + 2, w + 2, xp.shape[1])[:, 1:h + 1, 1:w + 1, :]


def block_constants(squeeze, expand, shortcut):
    """The kernel arguments of one residual block that depend on its
    chain-mode quantized params alone: every argument but ``scale1`` and
    ``s_x``, which follow the scale of the block's input.

    ``squeeze`` / ``expand``: the 1×1 and 3×3 conv entries (``kernel_q``
    (cout, kh, kw, cin), ``w_scale``, ``bias``, ``out_scale``); ``shortcut``:
    the shortcut layer's entry (``out_scale``). Every scalar is the f32 value
    the unfused chain computes (``w_scale·in_scale``, ``1/out_scale``), so
    the fused block is bit-equal to it. The weights are new tensors (w1 a
    copy, w2 repacked tap-major), sharing no storage with the params.
    """
    k1, k2 = squeeze["kernel_q"], expand["kernel_q"]
    cm, c = k1.shape[0], k1.shape[3]
    if tuple(k1.shape) != (cm, 1, 1, c) or tuple(k2.shape) != (c, 3, 3, cm):
        raise ValueError(f"block_args: not a 1×1 squeeze + 3×3 expand pair: "
                         f"{tuple(k1.shape)}, {tuple(k2.shape)}")
    s1, s2 = squeeze["out_scale"], expand["out_scale"]
    return dict(
        w1=k1.reshape(cm, c).clone(),
        w2=k2.permute(1, 2, 0, 3).reshape(9, c, cm).contiguous(),
        bias1=squeeze["bias"], inv_s1=torch.reciprocal(s1),
        scale2=(expand["w_scale"] * s1).to(torch.float32), bias2=expand["bias"],
        inv_s2=torch.reciprocal(s2), s2=s2,
        inv_out=torch.reciprocal(shortcut["out_scale"]))


def block_args(squeeze, expand, shortcut, s_x):
    """One residual block's kernel arguments at input scale ``s_x`` (a 0-d
    f32 tensor) → ``(kwargs for fused_resblock, output scale)``. The
    constants come from ``squeeze["fused"]`` where the params were packed
    (``models/network.py::pack_fused_stages``), else from
    ``block_constants``."""
    constants = squeeze.get("fused") or block_constants(squeeze, expand, shortcut)
    return (dict(constants, scale1=(squeeze["w_scale"] * s_x).to(torch.float32), s_x=s_x),
            shortcut["out_scale"])


def residual_blocks(sm):
    """The residual stages of a sub-model: a list of stages, each the list of
    layer indices ``i`` at which a block starts (``i``: 1×1 stride-1 conv,
    ``i+1``: 3×3 stride-1 conv, ``i+2``: shortcut from −3), consecutive blocks
    forming one stage."""
    stages, i, n = [], 0, len(sm.layers)
    while i + 2 < n:
        a, b, c = sm.layers[i:i + 3]
        if (a.kind == "convolutional" and a.get("size") == 1 and a.get("stride") == 1
                and b.kind == "convolutional" and b.get("size") == 3 and b.get("stride") == 1
                and b.get("pad", 1) == 1 and a.get("activation") == "leaky"
                and b.get("activation") == "leaky"
                and c.kind == "shortcut" and int(c["from"]) == -3):
            if stages and stages[-1][-1] == i - 3:
                stages[-1].append(i)
            else:
                stages.append([i])
            i += 3
        else:
            i += 1
    return stages


def fused_stage(x, sm_params, starts):
    """Run one residual stage through the fused kernel, chained in halo layout:
    one ``to_halo`` in, one block launch per entry of ``starts`` (layer indices
    from ``residual_blocks``), one ``from_halo`` out. ``x``: the stage's input
    as ``(q, scale)`` with q (B, H, W, C) int8; ``sm_params``: the sub-model's
    chain-mode quantized params. Returns ``(q, scale)`` of the stage's output."""
    q, scale = x
    b, h, w, _ = q.shape
    xp = to_halo(q)
    for i in starts:
        kwargs, scale = block_args(sm_params[f"layer{i}"], sm_params[f"layer{i + 1}"],
                                   sm_params[f"layer{i + 2}"], scale)
        xp = fused_resblock(xp, **kwargs, b=b, h=h, w=w)
    return from_halo(xp, b, h, w).contiguous(), scale


def fused_resblock_plain(xp, w1, w2, scale1, bias1, inv_s1, scale2, bias2, inv_s2, s2, s_x,
                         inv_out, *, b: int, h: int, w: int, halo_top: bool = False,
                         halo_bottom: bool = False):
    """Plain PyTorch version, exact on the CPU and on the card: both products
    run in float64 (exact for these sums) and are rounded to float32 once,
    then the epilogues in float32 in the kernel's order."""
    c, cm = xp.shape[1], w1.shape[0]
    x4 = xp.reshape(b, h + 2, w + 2, c)
    acc1 = (x4.to(torch.float64) @ w1.to(torch.float64).t()).to(torch.float32)
    q1 = requant_clip(leaky(acc1 * scale1 + bias1), inv_s1)
    mask = torch.from_numpy(halo_mask(h, w, halo_top, halo_bottom)).to(xp.device).reshape(
        1, h + 2, w + 2, 1)
    q1 = torch.where(mask != 0, q1, torch.zeros_like(q1))
    # the zero halo is the 3×3 conv's SAME padding: a VALID conv over it
    weight = w2.reshape(3, 3, c, cm).permute(2, 3, 0, 1).to(torch.float64)
    acc2 = F.conv2d(q1.permute(0, 3, 1, 2).to(torch.float64), weight)
    acc2 = acc2.round().permute(0, 2, 3, 1).to(torch.float32)
    q2 = requant_clip(leaky(acc2 * scale2 + bias2), inv_s2)
    yf = x4[:, 1:h + 1, 1:w + 1].to(torch.float32) * s_x + q2 * s2
    out = torch.zeros_like(x4)
    out[:, 1:h + 1, 1:w + 1] = requant_clip(yf, inv_out).to(torch.int8)
    return out.reshape(xp.shape)


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, c: int, cm: int, sms: int = _SMS):
    """What ``resblock_int8_launch`` is given and does for one block:
    ``dict(band_rows, slice_cols, bn1, bn2, bands, slices, items, grid,
    smem)``. The work is cut into items (image, band of ``band_rows`` output
    rows, slice of ``slice_cols`` output channels), which a persistent grid of
    ``grid`` blocks (one an SM, or one an item if fewer) walks in order. The
    tile widths (``_squeeze_tiles``) are a pair of ``TILES``; a shape with
    none raises. Of the cuts that fit shared memory, the one with the fewest
    128×32×128 product steps on the slowest SM wins, counting the
    zero-padded ends of both contractions, the halo rows a band
    recomputes, the whole squeeze that every slice recomputes, the rows of
    the last M-tile that lie past the band, and a fixed cost a tile."""
    wp = w + 2
    bn2, bn1s = _squeeze_tiles(c, cm)
    if not bn1s:
        raise ValueError(f"fused_resblock: no tile pair of {TILES} for C={c}, Cm={cm}")
    squeeze_k = -(-c // _BK)
    expand_k = -(-9 * cm // _BK)
    best = None
    for bn1, slices in itertools.product(bn1s, (1, 2, 4, 8, 16, 32)):
        if slices > 1 and (c % slices or (c // slices) % bn2):
            continue
        for rows in range(1, h + 1):
            smem = smem_bytes(w, cm, rows, bn1, bn2)
            if smem > _MAX_SMEM:
                break
            bands = -(-h // rows)
            items = b * bands * slices
            squeeze = (-(-(rows + 2) * wp // _BM) * -(-cm // bn1)
                       * (squeeze_k * bn1 // 32 + _TILE_OVERHEAD))
            expand = (-(-rows * wp // _BM) * -(-(c // slices) // bn2)
                      * (expand_k * bn2 // 32 + _TILE_OVERHEAD))
            cost = -(-items // sms) * (squeeze + expand)
            if best is None or cost < best[0]:
                best = (cost, dict(band_rows=rows, slice_cols=c // slices, bn1=bn1, bn2=bn2,
                                   bands=bands, slices=slices, items=items,
                                   grid=min(items, sms), smem=smem))
    if best is None:
        raise ValueError(f"fused_resblock: no band of a {h}×{w} image at Cm={cm} fits "
                         f"{_MAX_SMEM} bytes of shared memory")
    return best[1]


def fused_resblock(xp, w1, w2, scale1, bias1, inv_s1, scale2, bias2, inv_s2, s2, s_x, inv_out,
                   *, b: int, h: int, w: int, halo_top: bool = False, halo_bottom: bool = False):
    """One residual block over the flat zero-halo layout, through the
    ``yolov3_torch::fused_resblock`` op.

    xp (B·(H+2)·(W+2), C) int8 zero-halo; w1 (Cm, C) int8; w2 (9, C, Cm) int8;
    scale1/bias1 (Cm,) f32 with scale1 = w1_scale·s_x; scale2/bias2 (C,) f32
    with scale2 = w2_scale·s1; the five scalars 0-d f32 tensors (the f32
    reciprocals and scales of the unfused chain). Returns the same-shape
    halo matrix at scale 1/inv_out. ``halo_top`` / ``halo_bottom``: that
    halo row holds a neighbouring band's pixels (see the module's
    docstring). CPU tensors take the plain version; CUDA tensors launch
    ``resblock_int8_kernel`` (counted in ``fused_resblock.launches``) or
    raise."""
    return torch.ops.yolov3_torch.fused_resblock.default(
        xp, w1, w2, scale1, bias1, inv_s1, scale2, bias2, inv_s2, s2, s_x, inv_out, b, h, w,
        halo_top, halo_bottom)


fused_resblock.launches = 0
fused_resblock.edge_launches = 0  # of them, launches on a band with a neighbour's halo row


@torch.library.custom_op("yolov3_torch::fused_resblock", mutates_args=(), device_types="cpu")
def _resblock_op(xp: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, scale1: torch.Tensor,
                 bias1: torch.Tensor, inv_s1: torch.Tensor, scale2: torch.Tensor,
                 bias2: torch.Tensor, inv_s2: torch.Tensor, s2: torch.Tensor, s_x: torch.Tensor,
                 inv_out: torch.Tensor, b: int, h: int, w: int, halo_top: bool = False,
                 halo_bottom: bool = False) -> torch.Tensor:
    return fused_resblock_plain(xp, w1, w2, scale1, bias1, inv_s1, scale2, bias2, inv_s2, s2,
                                s_x, inv_out, b=b, h=h, w=w, halo_top=halo_top,
                                halo_bottom=halo_bottom)


@_resblock_op.register_kernel("cuda")
def _resblock_cuda(xp, w1, w2, scale1, bias1, inv_s1, scale2, bias2, inv_s2, s2, s_x, inv_out,
                   b, h, w, halo_top=False, halo_bottom=False):
    c, cm = xp.shape[1], w1.shape[0]
    if (xp.dim() != 2 or xp.shape[0] != b * (h + 2) * (w + 2) or tuple(w1.shape) != (cm, c)
            or tuple(w2.shape) != (9, c, cm)):
        raise ValueError(f"fused_resblock: shapes {tuple(xp.shape)}, {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} for b={b}, h={h}, w={w}")
    if c % 32 or cm % 16:
        raise ValueError(f"fused_resblock: needs C % 32 == 0 and Cm % 16 == 0, got {c}, {cm}")
    # a loaded program's strides need not be the trace's (``nms_kernel.py``)
    tensors = xp, w1, w2, scale1, bias1, scale2, bias2 = [
        t.contiguous() for t in (xp, w1, w2, scale1, bias1, scale2, bias2)]
    if any(t.data_ptr() % 16 for t in (xp, w1, w2)):
        raise ValueError("fused_resblock: needs 16-byte aligned xp, w1 and w2")
    if any(t.device != xp.device for t in tensors):
        raise ValueError("fused_resblock: needs tensors on one device")
    if any(t.dtype != torch.int8 for t in tensors[:3]) or any(
            t.dtype != torch.float32 for t in tensors[3:]):
        raise ValueError("fused_resblock: needs int8 xp/w1/w2 and f32 scales and biases")
    if (tuple(scale1.shape), tuple(bias1.shape), tuple(scale2.shape),
            tuple(bias2.shape)) != ((cm,), (cm,), (c,), (c,)):
        raise ValueError("fused_resblock: scale/bias shapes do not match (Cm,), (C,)")
    if xp.numel() >= 2 ** 31:
        raise ValueError("fused_resblock: activation too large for 32-bit row indices")
    scalars = [torch.as_tensor(v, dtype=torch.float32, device=xp.device)
               for v in (inv_s1, inv_s2, s2, s_x, inv_out)]
    if any(t.numel() != 1 for t in scalars):
        raise ValueError("fused_resblock: inv_s1, inv_s2, s2, s_x and inv_out are scalars")
    pl = plan(b, h, w, c, cm)
    out = torch.empty_like(xp)
    build.launch(build.function("resblock_int8", "resblock_int8_launch"), xp.device,
                 "resblock_int8", xp.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                 scale1.data_ptr(), bias1.data_ptr(), scale2.data_ptr(), bias2.data_ptr(),
                 *(t.data_ptr() for t in scalars), out.data_ptr(), b, h, w, c, cm, pl["band_rows"],
                 pl["slice_cols"], pl["bn1"], pl["bn2"], int(halo_top), int(halo_bottom))
    fused_resblock.launches += 1
    fused_resblock.edge_launches += bool(halo_top or halo_bottom)
    return out


@_resblock_op.register_fake
def _resblock_fake(xp, w1, w2, scale1, bias1, inv_s1, scale2, bias2, inv_s2, s2, s_x, inv_out,
                   b, h, w, halo_top=False, halo_bottom=False):
    return torch.empty_like(xp)
